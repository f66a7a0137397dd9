"""The frozen work and bound arithmetic, against hand counts and against the
originals in chip_smoke.py."""

import math

import numpy as np
import pytest

from hdbench import roofline


def test_gcl_work_by_hand():
    # h = 4, e = 2; 3 edges, 2 nodes, b = 1, n = 2
    flops, sfu, nbytes = roofline.gcl_work(3, 2, 1, 2, h=4, e=2)
    assert flops == 3 * (2 * 16 + 2 * 2 * 4 + 2 * 4) + 2 * 10 * 16
    assert sfu == 3 * (4 * 4 + 2) + 2 * 2 * 4
    pair = (2 * 16 + 2 * 4 + 16) * 2 + 2 * 4 * 4
    assert nbytes == 2 * 4 * 4 * 2 + 4 * 2 * 4 + 4 * 4 + 2 * 4 + pair + (4 + 3 * 16) * 2 + 3 * 4 * 4


def test_coord_and_bwd_work_by_hand():
    flops, sfu, _ = roofline.coord_work(5, 3, 1, 3, h=4, e=2)
    assert flops == 5 * (32 + 16 + 8) + 3 * 4 * 16
    assert sfu == 5 * 17
    flops, sfu, _ = roofline.bwd_work(5, 3, 1, 3, h=4, e=2)
    assert flops == 5 * (6 * 16 + 6 * 2 * 4 + 6 * 4) + 3 * 28 * 16
    assert sfu == 5 * 18 + 3 * 8


def test_bound_takes_the_largest():
    ms, by, parts = roofline.bound(989e12, 0.0, 0.0, 1.98e9, 132)
    assert math.isclose(ms, 1e3) and by == "operations"
    ms, by, _ = roofline.bound(0.0, 0.0, 3.35e12, 1.98e9, 132)
    assert math.isclose(ms, 1e3) and by == "bytes"
    ms, _, parts = roofline.bound(0.0, 16 * 132 * 1.98e9, 0.0, 1.98e9, 132)
    assert math.isclose(parts["sfu_ms"], 1e3)


@pytest.mark.parametrize("fn", ["gcl_work", "coord_work", "bwd_work"])
def test_copies_match_chip_smoke(fn):
    import chip_smoke

    counts = np.array([3, 7, 12, 35])
    edges, nodes = chip_smoke.complete_graphs(counts)
    assert (edges, nodes) == roofline.complete_graph_work(counts)
    assert getattr(chip_smoke, fn)(edges, nodes, 4, 35) == getattr(roofline, fn)(edges, nodes, 4, 35)
    work = getattr(roofline, fn)(edges, nodes, 4, 35)
    assert chip_smoke.bound(*work, 1.98e9, 132) == roofline.bound(*work, 1.98e9, 132)


def test_step_flops_are_the_kernels():
    edges, nodes = roofline.complete_graph_work([5, 9, 14])
    gcl = roofline.gcl_work(edges, nodes, 3, 14)[0]
    coord = roofline.coord_work(edges, nodes, 3, 14)[0]
    assert roofline.egnn_forward_flops(edges, nodes) == 6 * (2 * gcl + coord) + nodes * 4 * 9 * 256
