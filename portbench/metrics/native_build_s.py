"""Host seconds the run's process spent building and loading the CUDA
kernels and the native C++ libraries: the program's once-a-process totals
``kernels.build`` and ``native.build`` (``odgi_tpu_torch/utils/metrics.py``
``TOTALS``), read after the window.  Nothing is read where the program
keeps no such totals or neither step ran."""

NAMES = ("kernels.build", "native.build")


def read(run):
    from odgi_tpu_torch.utils import metrics

    totals = getattr(metrics, "TOTALS", {})
    if not any(n in totals for n in NAMES):
        return None
    return sum(totals[n]["seconds"] for n in NAMES if n in totals)
