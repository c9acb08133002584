"""chip_smoke.py on the CPU at a tiny size: every phase's code path
runs and its checks pass, the device check refuses a non-GPU platform,
and the result line has the contract's shape.  (The full-size run
needs a GPU: ``python chip_smoke.py``.)"""
import json

import jax
import pytest

import chip_smoke as cs

TINY = cs.Sizes(
    genome_mbp=0.3, n_map=8, n_stream=192, n_long=3, n_compare=96,
    n_fe_batches=1, n_ext_jobs=48, procs=2,
)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        cs.require_gpu()
    assert exc.value.code == 2


def test_main_refuses_cpu_and_prints_no_result(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code == 2
    assert '"ok"' not in capsys.readouterr().out


def test_result_line_contract():
    line = cs.result_line(jax.devices())
    assert "\n" not in line
    d = json.loads(line)
    assert list(d) == ["ok", "device"] and d["ok"] is True
    assert list(d["device"]) == ["platform", "kind", "count"]
    assert d["device"]["platform"] == jax.devices()[0].platform
    assert d["device"]["count"] == len(jax.devices())


def test_one_card_phases_tiny():
    out = cs.one_card_phases(TINY)
    assert out["map"]["placed"] == TINY.n_map
    st = out["stream"]
    assert st["reads"] == TINY.n_stream + 2 * TINY.n_long
    assert st["child_platforms"] == ["cpu"] * TINY.procs
    assert st["fe_batches"] > 0
    assert out["cpu_path"]["full_pct_of_mapped"] >= 99.5
    assert out["same_graph"]["differing"] == 0
    assert out["extension"]["jobs"] > 0
    assert out["extension"]["differing"] == 0
    assert out["front_end_memory"]["temp_size_in_bytes"] > 0


def test_four_card_phases_tiny():
    out = cs.four_card_phases(cs.Sizes(genome_mbp=0.3, n_stream=64))
    assert out["mesh_dp4"]["differing_reads"] == 0
    assert out["mesh_2x2_sharded_index"]["differing_reads"] == 0
    assert out["positions_2x2"]["differing"] == 0


def test_check_raises():
    cs.check(True, "fine")
    with pytest.raises(cs.SmokeFailure, match="broken"):
        cs.check(False, "broken")
