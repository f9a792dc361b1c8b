"""odgi_tpu_torch: the PyTorch/CUDA port of odgi_tpu for one NVIDIA H100.

The entry points of the GFA -> sort "Ygs" -> 2D layout -> .lay path.  Each
takes ``device``: ``None`` means the card, and without one they raise;
``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""

from .algorithms.layout import init_layout, layout_graph
from .algorithms.path_sgd_sort import sort_pipeline
from .algorithms.stats import sum_of_path_node_distances
from .convert import graph_from_arrays
from .core.graph import GraphBuilder, GraphTensors
from .io.gfa import parse_gfa, write_gfa
from .io.lay import load_layout, save_layout
from .io.og import load_graph, save_graph

__all__ = [
    "GraphBuilder", "GraphTensors", "graph_from_arrays", "init_layout",
    "layout_graph", "load_graph", "load_layout", "parse_gfa", "save_graph",
    "save_layout", "sort_pipeline", "sum_of_path_node_distances", "write_gfa",
]
