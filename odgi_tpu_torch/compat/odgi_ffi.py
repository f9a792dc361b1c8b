"""The ``import odgi_ffi`` functional API (the reference's C API,
src/odgi-api.h:44-117, walked through in test/python/odgi_ffi.md), the
counterpart of ``odgi_tpu/compat/odgi_ffi.py``.

``from odgi_tpu_torch.compat.odgi_ffi import *`` gives a reference FFI
script its functions over the port's ``odgi.graph``;
``odgi_load_graph(filename, device=None)`` loads on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from .odgi import graph as _graph, step_handle as _step


def odgi_version() -> str:
    from .. import version

    return version.get_version()


def odgi_long_long_size() -> int:
    """Bit width of the FFI integer type (reference: odgi-api.cpp:29)."""
    return 64


def odgi_handle_i_size() -> int:
    """Bit width of a node handle (reference: odgi-api.cpp:33)."""
    return 64


def odgi_step_handle_i_size() -> int:
    """Bit width of a step handle (reference: odgi-api.cpp:37)."""
    return 128


def odgi_load_graph(filename: str, device=None) -> _graph:
    g = _graph(device)
    g.load(filename)
    return g


def odgi_free_graph(g: _graph) -> None:
    g.clear()


def odgi_get_node_count(g: _graph) -> int:
    return g.get_node_count()


def odgi_max_node_id(g: _graph) -> int:
    return g.max_node_id()


def odgi_min_node_id(g: _graph) -> int:
    return g.min_node_id()


def odgi_get_path_count(g: _graph) -> int:
    return g.get_path_count()


def odgi_for_each_path_handle(g: _graph, iteratee) -> None:
    g.for_each_path_handle(iteratee)


def odgi_for_each_handle(g: _graph, iteratee) -> bool:
    return g.for_each_handle(iteratee)


def odgi_follow_edges(g: _graph, handle: int, go_left: bool, iteratee) -> bool:
    return g.follow_edges(handle, go_left, iteratee)


def odgi_edge_first_handle(g: _graph, e) -> int:
    return e.first()


def odgi_edge_second_handle(g: _graph, e) -> int:
    return e.second()


def odgi_has_node(g: _graph, node_id: int) -> bool:
    return g.has_node(node_id)


def odgi_get_sequence(g: _graph, handle: int) -> str:
    return g.get_sequence(handle)


def odgi_get_id(g: _graph, handle: int) -> int:
    return g.get_id(handle)


def odgi_get_is_reverse(g: _graph, handle: int) -> bool:
    return g.get_is_reverse(handle)


def odgi_get_length(g: _graph, handle: int) -> int:
    return g.get_length(handle)


def odgi_has_path(g: _graph, path_name: str) -> bool:
    return g.has_path(path_name)


def odgi_path_is_empty(g: _graph, path: int) -> bool:
    return g.is_empty(path)


def odgi_get_path_handle(g: _graph, path_name: str) -> int:
    return g.get_path_handle(path_name)


def odgi_get_path_name(g: _graph, path: int) -> str:
    return g.get_path_name(path)


def odgi_get_step_count(g: _graph, handle: int) -> int:
    return g.get_step_count(handle)


def odgi_get_handle_of_step(g: _graph, step: _step) -> int:
    return g.get_handle_of_step(step)


def odgi_get_path(g: _graph, step: _step) -> int:
    return g.get_path(step)


def odgi_path_begin(g: _graph, path: int) -> _step:
    return g.path_begin(path)


def odgi_path_end(g: _graph, path: int) -> _step:
    return g.path_end(path)


def odgi_path_back(g: _graph, path: int) -> _step:
    return g.path_back(path)


def odgi_path_front_end(g: _graph, path: int) -> _step:
    return g.path_front_end(path)


def odgi_step_path_id(g: _graph, step: _step) -> int:
    return step.path_id()


def odgi_step_is_reverse(g: _graph, step: _step) -> bool:
    return step.is_reverse()


def odgi_step_prev_id(g: _graph, step: _step) -> int:
    return step.prev_id()


def odgi_step_prev_rank(g: _graph, step: _step) -> int:
    return step.prev_rank()


def odgi_step_next_id(g: _graph, step: _step) -> int:
    return step.next_id()


def odgi_step_next_rank(g: _graph, step: _step) -> int:
    return step.next_rank()


def odgi_step_eq(g: _graph, a: _step, b: _step) -> bool:
    return a == b


def odgi_get_next_step(g: _graph, step: _step) -> _step:
    return g.get_next_step(step)


def odgi_get_previous_step(g: _graph, step: _step) -> _step:
    return g.get_previous_step(step)


def odgi_has_edge(g: _graph, left: int, right: int) -> bool:
    return g.has_edge(left, right)


def odgi_is_path_front_end(g: _graph, step: _step) -> bool:
    return g.is_path_front_end(step)


def odgi_is_path_end(g: _graph, step: _step) -> bool:
    return g.is_path_end(step)


def odgi_has_next_step(g: _graph, step: _step) -> bool:
    return g.has_next_step(step)


def odgi_has_previous_step(g: _graph, step: _step) -> bool:
    return g.has_previous_step(step)


def odgi_get_path_handle_of_step(g: _graph, step: _step) -> int:
    return g.get_path_handle_of_step(step)


def odgi_for_each_step_in_path(g: _graph, path: int, iteratee) -> None:
    g.for_each_step_in_path(path, iteratee)


def odgi_for_each_step_on_handle(g: _graph, handle: int, iteratee) -> bool:
    return g.for_each_step_on_handle(handle, iteratee)


__all__ = [n for n in list(globals()) if n.startswith("odgi_")]
