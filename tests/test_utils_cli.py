"""Tests for the case runner, CLI, tiling model, checkpointing, timing."""

import io
import jax
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from raymarchdenoiser import testing as rt
from raymarchdenoiser.utils import tiling, checkpoint
from raymarchdenoiser.gbuffer import History


@pytest.fixture(autouse=True)
def clean_registry():
    saved = dict(rt.registered_funcs)
    rt.registered_funcs.clear()
    yield
    rt.registered_funcs.clear()
    rt.registered_funcs.update(saved)


def test_case_registration_and_regex_run():
    calls = []

    @rt.case_("ALPHA")
    def a():
        calls.append("a")

    @rt.case_("ALPHA_TWO")
    def a2():
        calls.append("a2")

    @rt.skip("SKIPPED")
    def s():
        calls.append("s")

    lines = []
    ok = rt.run("ALPHA", out=lines.append)
    assert ok
    # full-match semantics: only ALPHA, not ALPHA_TWO (reference regex_match)
    assert calls == ["a"]
    assert any("Passed with" in l for l in lines)


def test_failing_case_reports_fail():
    @rt.case_("BOOM")
    def b():
        raise RuntimeError("exploded")

    lines = []
    ok = rt.run(".*", out=lines.append)
    assert not ok
    assert any("Fail with exploded" in l for l in lines)


def test_cli_help_and_unknown(capsys):
    from raymarchdenoiser import cli

    assert cli.main(["-h"]) == 0
    out = capsys.readouterr().out
    assert "-t [label]" in out
    assert cli.main(["--bogus"]) == 2
    assert "Unknown option" in capsys.readouterr().err


def test_cli_runs_image_case(capsys):
    from raymarchdenoiser import cli

    rc = cli.main(["-t", "IMAGE"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Passed with" in out


def test_tiling_model_matches_notebook():
    # notebook: space(n)=2^(n-1) for 1-based n; halo r*(1+space) ~ our r*2^l
    assert [tiling.spacing(l) for l in range(5)] == [1, 2, 4, 8, 16]
    assert tiling.halo_radius(2, 4) == 32
    assert tiling.tile_extent(2, 0, 16) == 20  # notebook level-0 tile 20
    halo = tiling.halo_bytes(270, 480, 2, 5)
    assert halo[4] > halo[0]
    # level 0 on a 270x480 tile: 2-px rows both sides + cols incl. corners
    assert halo[0] == 9 * 4 * (2 * 2 * 480 + 2 * 2 * (270 + 4))


def test_checkpoint_roundtrip(tmp_path):
    h = History.zeros(16, 24)
    h = h.replace(color=h.color + 0.5, length=h.length + 3)
    p = str(tmp_path / "hist.npz")
    checkpoint.save(p, h)
    h2 = checkpoint.restore(p, History.zeros(16, 24))
    np.testing.assert_allclose(np.asarray(h2.color), np.asarray(h.color))
    np.testing.assert_allclose(np.asarray(h2.length), np.asarray(h.length))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    h = History.zeros(16, 24)
    p = str(tmp_path / "hist.npz")
    checkpoint.save(p, h)
    with pytest.raises(ValueError):
        checkpoint.restore(p, History.zeros(8, 8))


def test_csv_dump(tmp_path):
    from raymarchdenoiser.utils.timing import CsvDump

    p = str(tmp_path / "out.csv")
    d = CsvDump(p)
    d.row("FILTER_TILED", 1.234, radius=2)
    d.row("FILTER_TILED", 1.200, radius=2)
    lines = open(p).read().strip().split("\n")
    assert len(lines) == 2
    assert lines[0].startswith("FILTER_TILED|1.2340|radius=2")


def test_checkpoint_orbax_roundtrip(tmp_path):
    """The orbax path itself (not the .npz fallback) round-trips a pytree."""
    pytest.importorskip("orbax.checkpoint")
    from raymarchdenoiser.utils import checkpoint

    tree = {"a": jnp.arange(6.0).reshape(2, 3), "b": {"c": jnp.ones((4,))}}
    path = str(tmp_path / "ckpt_orbax")
    checkpoint.save_orbax(path, tree)
    assert os.path.isdir(path), "orbax should write a directory, not .npz"
    like = jax.tree.map(jnp.zeros_like, tree)
    got = checkpoint.restore_orbax(path, like)
    np.testing.assert_allclose(np.asarray(got["a"]), np.asarray(tree["a"]))
    np.testing.assert_allclose(np.asarray(got["b"]["c"]), 1.0)


def test_timer_syncs_registered_result():
    from raymarchdenoiser.utils.timing import Timer

    x = jnp.ones((256, 256))
    with Timer() as t:
        t.sync(jnp.sum(x @ x))
    assert t.ms >= 0.0
    # no registered result: falls back to syncing live arrays
    with Timer() as t2:
        _ = x * 2
    assert t2.ms >= 0.0
