"""The tiny size of the cell ``chrom-90hap.sort-Ygs`` for these tests.

``helpers.TINY`` names a size of every cell in ``BENCHMARK.json``
(``test_portbench_cells.py::test_every_cell_has_its_files``).  This cell was
added as new files and entries alone, with every existing benchmark file
left as it is, so its size is registered here, before the test modules are
collected.  It belongs in ``helpers.TINY``; once it is there, this file
goes.
"""

from portbench.tests.helpers import TINY

# 34,000 nodes: past 32,767 a 1D run takes the xxl route, as the cell's
# does.  4 haplotypes: at 2, about 18 nodes lie on no path; such nodes are
# alike and have no edges, so a fault that swaps the first two nodes of the
# topological order may swap two of them and leave the sorted graph as it
# was (the cell's 90 haplotypes leave no node off the paths).
TINY.setdefault("chrom-90hap.sort-Ygs", dict(haplotypes=4, nodes=34000))
