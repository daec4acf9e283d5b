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


def test_compare_trees_reads_the_compared_numbers():
    """``compare_trees.summarize`` picks each phase's wall time, the LM
    serving lines' step times, the service rates and the timed kernels'
    ms out of a run's log, and passes over every other line."""
    from repro_torch.analysis import compare_trees
    log = "\n".join([
        "NVIDIA H100 80GB HBM3, 700.00 W",
        '[phase] {"name": "4 Mamba2 serving", "wall_s": 21.5}',
        '[lm_serve] {"batch": 4, "prefill_ms": 113.9, "decode_ms_mean": 59.0,'
        ' "decode_ms_p50": 55.0, "launches": {}}',
        '[dense_serve] {"prefill_ms": 90.0, "decode_ms_mean": 30.0}',
        '[service] {"what": "co-sim", "tenants": 1024, '
        '"decisions_per_s": 1280.2}',
        '[service] {"what": "journal", "decisions": 3}',
        '[time] {"name": "flash_attention_bwd", "ms": 0.3660, "plain_ms": 5.5}',
        "[check] not json",
    ])
    assert compare_trees.summarize(log) == {
        "phase_s": {"4 Mamba2 serving": 21.5},
        "lm_serve": {"prefill_ms": 113.9, "decode_ms_mean": 59.0,
                     "decode_ms_p50": 55.0},
        "dense_serve": {"prefill_ms": 90.0, "decode_ms_mean": 30.0},
        "service co-sim": 1280.2, "time flash_attention_bwd": 0.3660}
    assert compare_trees.ORDER == ("parent", "change", "change", "parent")
    assert set(compare_trees.RUNS) == {"serving", "backward"}


def test_sass_diff_blanks_what_a_new_parameter_moves():
    """``sass_diff`` splits ``cuobjdump -sass``'s listing by kernel, blanks
    addresses, encodings, jump targets and parameter offsets (so a kernel
    that only gained a parameter reads the same) and keeps every other
    operand; it reads registers and spills from ``-Xptxas=-v``."""
    from repro_torch.analysis import sass_diff
    dump = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _Z1kILi32EEvPfi",
        '\t.headerflags\t@"EF_CUDA_SM90"',
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
        "          /* 0x00000a00ff017b82 */",
        "                                                      "
        "          /* 0x000fe40000000800 */",
        "        /*0010*/              @!P0 BRA 0x130 ;",
        "        /*0020*/                   IADD3 R2, R0, 0x10, RZ ;",
        "        .L_x_0:",
        "\t\tFunction : _Z1kILi32ELb0EEvPfii",
        "        /*0000*/                   LDC R1, c[0x0][0x2c] ;",
        "        /*0010*/              @!P0 BRA 0x150 ;",
        "        /*0020*/                   IADD3 R2, R0, 0x20, RZ ;",
    ])
    funcs = sass_diff.split_functions(dump)
    assert set(funcs) == {"_Z1kILi32EEvPfi", "_Z1kILi32ELb0EEvPfii"}
    old = sass_diff.normalise(funcs["_Z1kILi32EEvPfi"])
    new = sass_diff.normalise(funcs["_Z1kILi32ELb0EEvPfii"])
    assert old == ["LDC R1, c[0x0][param] ;", "@!P0 BRA addr ;",
                   "IADD3 R2, R0, 0x10, RZ ;"]
    assert new[:2] == old[:2] and new[2] == "IADD3 R2, R0, 0x20, RZ ;"
    assert sass_diff.find(funcs, "ILi32ELb0EE") == "_Z1kILi32ELb0EEvPfii"
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z1kILi32EEvPfi' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z1kILi32EEvPfi",
        "    16 bytes stack frame, 16 bytes spill stores, 28 bytes spill "
        "loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 16 bytes "
        "cumulative stack size",
    ])
    assert sass_diff.usage(log) == {"_Z1kILi32EEvPfi": {
        "stack": 16, "spill_stores": 16, "spill_loads": 28,
        "registers": 255}}


def test_sass_diff_pairs_every_kernel_by_name():
    """``--all`` pairs each kernel of the parent with the change's of the
    same mangled name, the anonymous namespace's per-file tag (which
    differs between two trees' builds) blanked; the change's kernels the
    parent lacks come back apart (the new forms)."""
    from repro_torch.analysis import sass_diff
    tag_a = "_ZN55_GLOBAL__N__04cf38d3_18_flash_attention_cu_2c1389792tc"
    tag_b = "_ZN55_GLOBAL__N__9a1b2c3d_18_flash_attention_cu_77aa00ff2tc"
    parent = [tag_a + "19flash_fwd_tc_kernelILi64EEEvPK13__nv_bfloat16",
              "_Z11split_sumPKfPfxi"]
    change = [tag_b + "19flash_fwd_tc_kernelILi64EEEvPK13__nv_bfloat16",
              "_Z11split_sumPKfPfxi",
              "_ZN55_GLOBAL__N__9a1b2c3d_18_flash_attention_cu_77aa00ff2wg"
              "19flash_fwd_wg_kernelILi64EEEv14CUtensorMap_st"]
    pairs, new = sass_diff.same_name_pairs(parent, change)
    assert pairs == list(zip(parent, change[:2]))
    assert new == [change[2]]
    # the SSD sources' tag ends in no hex hash; its length prefix bounds it
    ssd = ["_ZN37_GLOBAL__N__795c7cdb_6_ssd_cu_ssd_fwd10ssd_kernelI13__nv_"
           "bfloat16Li64EEEvPKT_", "_ZN37_GLOBAL__N__a1b2c3d4_6_ssd_cu_"
           "ssd_fwd10ssd_kernelI13__nv_bfloat16Li64EEEvPKT_"]
    assert sass_diff.same_name_pairs(ssd[:1], ssd[1:]) == ([tuple(ssd)], [])
