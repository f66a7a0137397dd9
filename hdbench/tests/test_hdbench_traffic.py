"""The frozen copies of the traffic give what their sources give at the
copied commit."""

import numpy as np
import pytest

from hdbench import traffic


def test_histograms_are_the_assets():
    from hierdiff_torch.data.assets import load_histogram

    for name in ("geom", "crossdock"):
        assert traffic.histogram(name) == load_histogram(name)


@pytest.mark.parametrize("seed", [1, 3])
def test_pockets_are_chip_smokes(seed, tmp_path):
    import chip_smoke
    from hierdiff_torch.chem.pocket import collate_pockets, pocket_from_pdb

    pdb = tmp_path / "site.pdb"
    chip_smoke.write_pocket_pdb(pdb, seed)
    ref = collate_pockets([pocket_from_pdb(str(pdb), np.zeros((1, 3)),
                                           radius=chip_smoke.POCKET_RADIUS)])
    got = traffic.pocket(np.random.default_rng(seed), chip_smoke.POCKET_CA)
    for key in ("protein_feat", "protein_feat_mask", "protein_edge_mask"):
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_allclose(got["protein_pos"], ref["protein_pos"], atol=6e-4)


def test_stratified_counts():
    counts = traffic.stratified_counts("geom", 256)
    assert counts.shape == (256,) and counts.max() == 35 and counts.min() >= 1
    assert np.all(np.diff(counts) >= 0)
    a = traffic.shuffled_counts("geom", 256, np.random.default_rng(1))
    b = traffic.shuffled_counts("geom", 256, np.random.default_rng(2))
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)


def test_masks_match_the_package():
    from hierdiff_torch.sampling.coarse import make_masks_for_counts

    counts = np.array([3, 8, 1, 5])
    node, edge = traffic.complete_masks(counts, 8)
    want = make_masks_for_counts(counts, 8)
    np.testing.assert_array_equal(node, np.asarray(want[0]))
    np.testing.assert_array_equal(edge, np.asarray(want[1]))
