"""The strata run's slot arrays in their host forms, the reference of the
tests that hold ``strata_sgd.fill_slots`` to them (on the CPU and on the
card).  Imports numpy alone."""

import numpy as np


def slot_arrays_numpy(g, num_slots, init, one_d):
    """(planes, base) as the host built them before the device filled them:
    the step planes from int64 copies of the step arrays, and `base`
    gathered from the f32 coordinates over every step."""
    S = g.num_steps
    handle = g.step_handle.astype(np.int64)
    node = handle >> 1
    pos = g.step_pos.astype(np.int64)
    path_id = g.step_path.astype(np.int64)
    if one_d:
        pl = np.zeros((3, num_slots), np.int32)
        pl[2] = -1
        pl[1] = 2 * g.num_nodes
        pl[0, :S] = pos
        pl[1, :S] = handle
        pl[2, :S] = path_id
        base = np.zeros((1, num_slots), np.float32)
        base[0, :S] = np.asarray(init, np.float32)[node]
        return pl, base
    pl = np.zeros((4, num_slots), np.int32)
    pl[3] = -1
    pl[2] = 2 * g.num_nodes
    pl[0, :S] = pos
    pl[1, :S] = pos + g.node_len[node]
    pl[2, :S] = handle
    pl[3, :S] = path_id
    c32 = np.asarray(init, np.float64).astype(np.float32)
    base = np.zeros((4, num_slots), np.float32)
    base[0, :S] = c32[handle, 0]
    base[1, :S] = c32[handle ^ 1, 0]
    base[2, :S] = c32[handle, 1]
    base[3, :S] = c32[handle ^ 1, 1]
    return pl, base
