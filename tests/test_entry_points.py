"""Entry-point plumbing: the compile-cache helper, chip_smoke.py's refusal to
run without a GPU, removed config keys, and the h5py-free input copy."""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE_PROBE = ("import jax; from nuradiomc_tpu.utils import compile_cache; "
                "d = compile_cache.enable(); "
                "print(d); print(jax.config.jax_compilation_cache_dir)")


def _python(code_or_args, cwd, **env):
    full_env = {k: v for k, v in os.environ.items()
                if k != "JAX_COMPILATION_CACHE_DIR"}
    full_env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, **env})
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full_env,
                          capture_output=True, text=True, timeout=300)


def test_compile_cache_defaults_to_checkout(tmp_path):
    """Unset: <checkout>/.jax_cache, the same from any working directory
    and in every process."""
    outs = []
    for cwd in (REPO, str(tmp_path)):
        r = _python(_CACHE_PROBE, cwd)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout.split())
    expected = os.path.join(REPO, ".jax_cache")
    assert outs[0] == outs[1] == [expected, expected]


def test_compile_cache_honours_environment(tmp_path):
    """Set: JAX reads the variable at start-up; no code sets another."""
    mine = str(tmp_path / "cache")
    r = _python(_CACHE_PROBE, REPO, JAX_COMPILATION_CACHE_DIR=mine)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [mine, mine]


@pytest.mark.parametrize("alone", [False, True],
                         ids=["checkout", "script_alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """No GPU (or no repo beside the script): non-zero exit, no "ok" line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    r = _python([script], cwd, PYTHONPATH="")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("key", ["placement_impl", "placement_phase",
                                 "trigger_impl"])
def test_removed_perf_key_raises(key):
    from nuradiomc_tpu.sim.simulation import Simulation

    with pytest.raises(ValueError, match=f"perf.{key}"):
        Simulation("unused.hdf5", {}, config={"perf": {key: "xla"}})


def test_npz_input_copy_matches_hdf5():
    """tests/data/1e18_n3000.npz (io_hdf5.write_input_npz of the .hdf5,
    read without h5py) holds the same input table as the .hdf5."""
    from nuradiomc_tpu.sim import io_hdf5

    base = os.path.join(REPO, "tests", "data", "1e18_n3000")
    a = io_hdf5.read_input_hdf5(base + ".hdf5")
    b = io_hdf5.read_input_npz(base + ".npz")
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "attrs":
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
                assert np.asarray(x[k]).dtype.kind == np.asarray(y[k]) \
                    .dtype.kind or isinstance(x[k], str), k
        elif x is None:
            assert y is None, f.name
        else:
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
