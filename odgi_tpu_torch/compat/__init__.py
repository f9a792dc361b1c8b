"""The reference odgi's Python bindings over the port, the counterpart of
``odgi_tpu/compat/``.

- ``odgi_tpu_torch.compat.odgi``: the ``import odgi`` pybind11 class API
  (reference: src/pythonmodule.cpp), a mutable ``graph`` class.
- ``odgi_tpu_torch.compat.odgi_ffi``: the ``import odgi_ffi`` C-API
  functions (reference: src/odgi-api.h, test/python/odgi_ffi.md).

Both work on the same mutable graph model, which freezes to the port's
GraphTensors; loading takes the port's device rule (None is the card).
"""
