"""Entry points around the solver: the compile-cache location, bench.py's
timing window, chip_smoke.py's device check, and checkpoints that carry
retired options."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from hnanosolver_tpu import _compile_cache as cc  # noqa: E402


# --- compile cache ---------------------------------------------------------

def test_cache_dir_defaults_to_fixed_path_in_checkout():
    path = cc.choose_dir({})
    assert path == os.path.join(ROOT, ".jax_cache")
    assert cc.choose_dir({}) == path  # no temp name, pid or time in it
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_dir_env_var_wins_and_nothing_else_is_set(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cc.configure({cc.ENV_VAR: "/elsewhere"}) is None
    assert calls == []
    assert cc.configure({}) == cc.DEFAULT_DIR
    assert calls == [("jax_compilation_cache_dir", cc.DEFAULT_DIR)]


def test_package_import_configures_the_cache():
    env = {k: v for k, v in os.environ.items() if k != cc.ENV_VAR}
    code = ("import jax, hnanosolver_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == cc.DEFAULT_DIR


# --- bench.py --------------------------------------------------------------

def test_timed_window_excludes_the_compile():
    traces = []

    @jax.jit
    def step(x):
        traces.append(1)
        return x * 0.5 + 1.0

    state, compile_s, per_step, n = bench.timed_window(
        step, jnp.ones((64,)), step, steps=5, warmup=2)
    assert len(traces) == 1 and n == 0
    assert compile_s > 0 and per_step > 0
    np.testing.assert_allclose(np.asarray(state), 2.0 - 2.0 ** -7)


def test_timed_window_counts_a_compile_inside_the_window():
    @jax.jit
    def grow(x):
        return jnp.concatenate([x, x[:1]])  # new shape every call

    _, _, _, n = bench.timed_window(grow, jnp.ones((4,)), grow, steps=3,
                                    warmup=1)
    assert n == 3


def test_bench_refuses_to_run_without_a_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_envelope_is_the_documented_cell():
    topo = bench.envelope_topology()
    assert int(topo.n_active) == 4196
    assert topo.capacity == 4608
    assert topo.num_voxels == 2_148_352


# --- chip_smoke.py ---------------------------------------------------------

def test_chip_smoke_refuses_a_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert "FAILED" in out and '"ok"' not in out


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_no_governor_engages_at_the_envelope():
    g = chip_smoke.governors(4608)
    assert g.pop("sampling chunks") == 6
    assert not any(g.values()), g
    big = chip_smoke.governors(269_312)  # 1024^3-class plume
    assert big["NBRSUM_VIEWS_BUDGET"] and big["ADVECT_TRANSIENT_BUDGET(scalars)"]


# --- checkpoints -----------------------------------------------------------

def test_checkpoint_with_retired_options_loads(tmp_path):
    from hnanosolver_tpu.config import SolverParams
    from hnanosolver_tpu.core.topology import build_topology_dense
    from hnanosolver_tpu.fields import zeros_state
    from hnanosolver_tpu.io.state import load_npz, save_npz

    topo = build_topology_dense((8, 8, 8))
    params = SolverParams(iterations=7)
    path = str(tmp_path / "old.npz")
    save_npz(path, topo, zeros_state(topo), params, frame=3)
    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(str(arrays.pop("meta")))
    meta["params"].update(precision="balanced", halo_lag=None)
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)
    _, _, loaded, frame = load_npz(path)
    assert loaded == params and frame == 3
