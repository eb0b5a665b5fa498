"""The port's fast-simulation engine on the CPU (`device="cpu"`, the plain
conv path): exact event counts, packing invariance, the gate's masking,
agreement with the JAX package's gate report and generator, the device
default, the launcher, and that the port imports neither JAX nor the JAX
package."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import calo3dgan as jcfgs
from repro.core import gan as jgan
from repro.core import validation as jval
from repro_torch.configs import calo3dgan as tcfgs
from repro_torch.convert import generator_from_numpy
from repro_torch.core import validation as tval
from repro_torch.data.calo import CaloSimulator, CaloSpec
from repro_torch.kernels.conv3d import conv3d as tconv
from repro_torch.launch import serve as tlaunch
from repro_torch.serve.simulate import (PhysicsGate, SimRequest,
                                        SimulateEngine, event_noise,
                                        event_seed)

CFG = tcfgs.bench()
JCFG = jcfgs.bench()
SIZES = (3, 5, 17, 1)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jgan.init_generator(jax.random.key(0), JCFG))


@pytest.fixture(scope="module")
def g_params(jax_params):
    return generator_from_numpy(jax_params, "cpu")


@pytest.fixture(scope="module")
def mc_reference():
    mc = next(CaloSimulator(CaloSpec(image_shape=CFG.image_shape),
                            seed=0).batches(64))
    return tval.reference_profiles(mc["image"], mc["e_p"])


def _engine(g_params, buckets=(4, 16), gate=None, policy_name="f32"):
    return SimulateEngine(CFG, g_params, buckets=buckets, gate=gate,
                          policy_name=policy_name, device="cpu")


def _requests():
    return [SimRequest(rid=i, primary_energy=100.0 + 30.0 * i, n_events=n,
                       seed=10 + i) for i, n in enumerate(SIZES)]


@pytest.mark.parametrize("policy_name", ["f32", "bf16"])
def test_odd_request_sizes_get_exactly_n_events(g_params, policy_name):
    eng = _engine(g_params, policy_name=policy_name)
    reqs = _requests()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    for r, n in zip(reqs, SIZES):
        assert r.done and r.status == "done"
        assert r.images.shape == (n, *CFG.image_shape, 1)
        assert r.images.dtype == np.float32
        assert np.all(np.isfinite(r.images)) and np.all(r.images >= 0)
    assert eng.stats["events_generated"] == sum(SIZES)
    assert eng.stats["device_transfers"] == len(SIZES)   # one per request
    assert tconv.LAUNCHES == 0                             # CPU: no kernel


def test_generation_bit_identical_across_packings(g_params):
    packed = _engine(g_params)
    reqs = _requests()
    for r in reqs:
        packed.submit(r)
    packed.run()
    assert packed.stats["bucket_steps"][16] >= 1
    for r in reqs:
        alone = _engine(g_params, buckets=(4, 8, 32)).generate_events(
            r.primary_energy, r.n_events, r.seed)
        np.testing.assert_array_equal(alone, r.images)


def test_event_noise_depends_only_on_seed_and_index():
    a = event_noise([7, 7, 9], [0, 1, 0], 5, "cpu", torch.float32)
    b = event_noise([9, 1, 7], [0, 0, 1], 5, "cpu", torch.float32)
    assert torch.equal(a[2], b[0]) and torch.equal(a[1], b[2])
    assert not torch.equal(a[0], a[1])
    assert event_noise([7], [0], 5, "cpu", torch.bfloat16).dtype == \
        torch.bfloat16
    assert len({event_seed(s, i) for s in range(20) for i in range(20)}) \
        == 400


def test_gate_counts_only_real_events(g_params, mc_reference):
    gate = PhysicsGate(mc_reference, window=10_000)
    eng = _engine(g_params, gate=gate)
    reqs = _requests()
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.stats["padded_events"] > 0
    rep = gate.flush()
    assert rep["count"] == sum(SIZES)
    images = np.concatenate([r.images for r in reqs])
    e_p = np.concatenate([np.full(r.n_events, r.primary_energy, np.float32)
                          for r in reqs])
    host = tval.gate_report(
        {"longitudinal": images.sum(axis=(0, 1, 2, 4)),
         "transverse_x": images.sum(axis=(0, 2, 3, 4)),
         "transverse_y": images.sum(axis=(0, 1, 3, 4)),
         "response": tval.energy_response(images, e_p).sum(),
         "count": len(images)}, mc_reference)
    for k in ("longitudinal_kl", "transverse_x_kl", "transverse_y_kl",
              "response_mean"):
        np.testing.assert_allclose(rep[k], host[k], rtol=1e-4, atol=1e-7)


def test_profile_sums_match_jax(mc_reference):
    rng = np.random.default_rng(3)
    img = rng.gamma(2.0, 0.01, size=(6, *CFG.image_shape, 1)).astype(
        np.float32)
    e_p = rng.uniform(10, 500, 6).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    got = tval.profile_sums(torch.from_numpy(img), torch.from_numpy(e_p),
                            torch.from_numpy(mask))
    want = jax.device_get(jval.profile_sums(jnp.asarray(img),
                                            jnp.asarray(e_p),
                                            jnp.asarray(mask)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5)
    host = {k: v.numpy() for k, v in got.items()}
    assert tval.gate_report(host, mc_reference) == \
        jval.gate_report(host, mc_reference)


def test_host_validation_matches_jax(mc_reference):
    mc = next(CaloSimulator(CaloSpec(image_shape=CFG.image_shape),
                            seed=4).batches(8))
    from repro.data.calo import CaloSimulator as JSim, CaloSpec as JSpec
    jmc = next(JSim(JSpec(image_shape=CFG.image_shape), seed=4).batches(8))
    np.testing.assert_array_equal(mc["image"], jmc["image"])
    assert tval.reference_profiles(mc["image"], mc["e_p"]).keys() == \
        jval.reference_profiles(jmc["image"], jmc["e_p"]).keys()
    for k, v in tval.reference_profiles(mc["image"], mc["e_p"]).items():
        np.testing.assert_array_equal(
            v, jval.reference_profiles(jmc["image"], jmc["e_p"])[k])


def test_engine_images_match_jax_generate_on_port_noise(g_params,
                                                        jax_params):
    eng = _engine(g_params)
    reqs = _requests()
    for r in reqs:
        eng.submit(r)
    eng.run()
    r = reqs[2]
    noise = event_noise([r.seed] * r.n_events, range(r.n_events),
                        CFG.latent_dim, "cpu", torch.float32).numpy()
    want = np.asarray(jgan.generate(
        jax_params, jnp.asarray(noise),
        jnp.full((r.n_events,), r.primary_energy, jnp.float32),
        jnp.full((r.n_events,), r.theta, jnp.float32), JCFG))
    np.testing.assert_allclose(r.images, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_default_device_is_cuda(g_params):
    if torch.cuda.is_available():
        assert _engine_default(g_params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            _engine_default(g_params)


def _engine_default(g_params):
    return SimulateEngine(CFG, g_params, buckets=(4,))


def test_rejects_bad_input(g_params):
    eng = _engine(g_params)
    with pytest.raises(ValueError, match="n_events"):
        eng.submit(SimRequest(rid=0, primary_energy=10.0, n_events=0))
    with pytest.raises(ValueError, match="bucket"):
        _engine(g_params, buckets=())
    with pytest.raises(ValueError, match="bucket"):
        _engine(g_params, buckets=(0, 4))


def test_expired_deadline_is_rejected_not_served(g_params):
    t = [0.0]
    eng = SimulateEngine(CFG, g_params, buckets=(4,), device="cpu",
                         clock=lambda: t[0])
    r = SimRequest(rid=0, primary_energy=50.0, n_events=3, deadline_s=1.0)
    eng.submit(r)
    t[0] = 2.0
    assert eng.run() == []
    assert r.status == "rejected" and r.error["reason"] == "deadline"
    assert eng.degraded_report()["rejected"] == 1


def test_launcher_serves_on_cpu(capsys):
    eng = tlaunch.main(["--device", "cpu", "--reduced", "--requests", "3",
                        "--max-events", "6"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "conv_kernel_launches=0" in out
    assert eng.stats["events_generated"] == sum(
        r.n_events for r in eng._finished)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300, env=env)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("serve.simulate", "kernels.build", "core.adversarial",
                "optim.optimizers", "train.engine", "launch.train",
                "configs.base", "configs.qwen2_1_5b", "substrate.attention",
                "kernels.flash_attention.ref", "kernels.flash_attention.decode",
                "kernels.flash_attention.flash_attention", "models.lm",
                "models.api", "train.steps", "serve.engine",
                "kernels.flash_attention.ops", "data.tokens",
                "train.checkpoint", "convert", "configs.zamba2_1_2b",
                "substrate.ssm", "kernels.ssm_scan.ref",
                "kernels.ssm_scan.ssm_scan", "kernels.ssm_scan.ops",
                "models.zamba"):
        assert f"repro_torch.{mod}" in res["modules"]
    assert res["bad"] == []
