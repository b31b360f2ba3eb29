"""The port's bench scripts edit copies of the kernel sources (mutants that
phases of ``chip_smoke.py`` must catch, ablations that take a part of a
kernel out).  Each edit must still apply to the sources as they are, the
number of times it names, or the script stops on the card before it has
measured anything."""

import pytest

import bench_common
import bench_flash_bwd
import bench_lrn
import bench_maxpool
import bench_quant


def _edit_sets():
    yield from (("maxpool mutant " + n, e)
                for n, e in bench_maxpool.MUTANTS.items())
    yield from (("maxpool ablation " + n, e)
                for n, (e, _) in bench_maxpool.ABLATIONS.items())
    yield from (("lrn mutant " + n, e)
                for n, e in bench_lrn.MUTANTS.items())
    yield from (("lrn ablation " + n, e)
                for n, (e, _) in bench_lrn.ABLATIONS.items())
    yield from (("quant mutant " + n, [e])
                for n, e in bench_quant.MUTANTS.items())
    yield from (("quant ablation " + n, e)
                for n, e in bench_quant.ABLATIONS.items())
    yield from (("quant f32 ablation " + n, e)
                for n, (e, _) in bench_quant.F32_ABLATIONS.items())
    yield from (("flash mutant " + n, e)
                for n, (e, _) in bench_flash_bwd.MUTANTS.items())
    yield from (("flash ablation " + n, e)
                for n, e in bench_flash_bwd.ABLATIONS.items())
    yield from (("flash fwd ablation " + n, e)
                for n, e in bench_flash_bwd.FWD_ABLATIONS.items())


EDIT_SETS = list(_edit_sets())


@pytest.mark.parametrize("name,edits", EDIT_SETS,
                         ids=[n.replace(" ", "-") for n, _ in EDIT_SETS])
def test_bench_edits_apply_to_the_sources(name, edits):
    bench_common.check_edits(edits, name)


def test_an_edit_that_no_longer_applies_stops_the_run():
    path = bench_maxpool.POOL_CU
    with pytest.raises(SystemExit, match="0 times, not 1"):
        bench_common.check_edits([(path, "no such text in the kernel", "")],
                                 "edit")
    with pytest.raises(SystemExit, match="not 2"):
        bench_common.check_edits([(path, "if (v > best) {", "", 2)], "edit")
    with pytest.raises(SystemExit, match="no longer changes"):
        bench_common.check_edits([(path, lambda text: text)], "edit")
    assert bench_common.edited("a b a", [("b", "c")], "edit") == "a c a"
    assert bench_common.edited("a b a", [("a", "c", 2)], "edit") == "c b c"


def test_ab_runs_parent_change_change_parent():
    runs = []
    rc = bench_common.ab("parent", lambda label, tree: runs.append(
        (label, tree)) or (3 if label == "change 1" else 0))
    assert [t for _, t in runs] == ["parent", bench_common.HERE,
                                    bench_common.HERE, "parent"]
    assert [label for label, _ in runs] == ["parent 1", "change 1",
                                            "change 2", "parent 2"]
    assert rc == 3
