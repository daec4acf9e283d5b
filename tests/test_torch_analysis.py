"""The SSD backward's clock-stamp copies still follow the kernel.

``repro_torch.analysis.ssd_bwd_phases`` patches copies of
``csrc/ssd_bwd.cu`` by text anchors before it builds and times them on the
card. Building needs nvcc, but patching does not: these tests make every
copy on the CPU, so an edit of the kernel that moves an anchor fails here
and not on the card.
"""
import pytest

from repro_torch.analysis import ssd_bwd_phases as phases

STAMPS = "g_phase[((blockIdx.z"


@pytest.fixture(scope="module")
def copies():
    return phases.copies()


def test_copies_are_the_three_named(copies):
    assert sorted(copies) == ["base", "checksum_stores",
                              "no_dx_db_products"]
    assert len(set(copies.values())) == 3


@pytest.mark.parametrize("name", ["base", "no_dx_db_products",
                                  "checksum_stores"])
def test_every_copy_stamps_five_points_at_one_shape(copies, name):
    src = copies[name]
    assert src.count(STAMPS) == len(phases.POINTS) == 5
    assert 'extern "C" int read_phases' in src
    assert "REPRO_SSD_BWD_TC_P(64)" in src and "REPRO_SSD_BWD_TC_N(128)" in src
    for gone in ("      REPRO_SSD_BWD_TC_P(16)\n",
                 "      REPRO_SSD_BWD_TC_P(128)\n",
                 "    REPRO_SSD_BWD_TC_N(64)\n"):
        assert gone not in src


def test_no_products_copy_drops_the_dx_and_db_products(copies):
    base, src = copies["base"], copies["no_dx_db_products"]
    assert src.count("dd < 0") == base.count("dd < 0") + 2
    for text in phases.DX_DB:
        assert text in base and text not in src


def test_checksum_copy_replaces_both_scratch_stores(copies):
    base, src = copies["base"], copies["checksum_stores"]
    for text in phases.STORES:
        assert text in base and text not in src
    assert src.count("float cs = 0.f;") == base.count("float cs = 0.f;") + 2
