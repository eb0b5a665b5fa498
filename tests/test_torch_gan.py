"""The port's generator against the JAX package's `gan.generate` on the
same parameters (carried across by `repro_torch.convert`) and the same
numpy noise: on the lax route at the reduced config and on the Pallas
route (interpret mode) at a tiny one, under the f32 and bf16 policies.
Plus the parameter round trip and the checkpoint format in both
directions.

Tolerances are relative to the largest shower cell: f32 1e-5 (summation
order), bf16 2e-2 (the packages round at different places)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import calo3dgan as jcfgs
from repro.core import gan as jgan
from repro.train import checkpoint as jckpt
from repro_torch.configs import calo3dgan as tcfgs
from repro_torch.convert import generator_from_numpy, generator_to_numpy
from repro_torch.core import gan as tgan
from repro_torch.train import checkpoint as tckpt

TINY = dict(image_shape=(6, 6, 5), latent_dim=6, gen_channels=(4, 3, 2),
            disc_channels=(2, 4), batch_size=4)
ROUTES = {
    # route: (JAX config, port config)
    "lax": (dataclasses.replace(jcfgs.reduced(), use_pallas_conv=False),
            tcfgs.reduced()),
    "pallas": (jcfgs.GANConfig(use_pallas_conv=True, **TINY),
               tcfgs.GANConfig(**TINY)),
}
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _jax_params(cfg, seed=0):
    return jax.device_get(jgan.init_generator(jax.random.key(seed), cfg))


def _labels(n, latent, seed=0):
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(n, latent)).astype(np.float32)
    e_p = rng.uniform(10.0, 500.0, n).astype(np.float32)
    theta = rng.uniform(1.0, 2.1, n).astype(np.float32)
    return noise, e_p, theta


def _jax_generate(params, noise, e_p, theta, cfg, jdt=jnp.float32):
    out = jgan.generate(params, jnp.asarray(noise, jdt), jnp.asarray(e_p),
                        jnp.asarray(theta), cfg)
    return np.asarray(out.astype(jnp.float32))


def _port_generate(params, noise, e_p, theta, cfg, tdt=torch.float32):
    with torch.inference_mode():
        out = tgan.generate(params, torch.from_numpy(noise).to(tdt),
                            torch.from_numpy(e_p), torch.from_numpy(theta),
                            cfg)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_generate_matches_jax(route, dtype):
    jcfg, tcfg = ROUTES[route]
    jdt, tdt, tol = DTYPES[dtype]
    jp = _jax_params(jcfg)
    noise, e_p, theta = _labels(3, jcfg.latent_dim)
    want = _jax_generate(jp, noise, e_p, theta, jcfg, jdt)
    got = _port_generate(generator_from_numpy(jp, "cpu"), noise, e_p, theta,
                         tcfg, tdt)
    assert got.shape == want.shape == (3, *tcfg.image_shape, 1)
    assert np.all(got >= 0)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def test_init_generator_has_the_reference_leaves():
    jcfg, tcfg = ROUTES["lax"]
    jp = _jax_params(jcfg)
    tp = generator_to_numpy(tgan.init_generator(
        torch.Generator().manual_seed(0), tcfg, "cpu"))
    jflat = {k: v.shape for k, v in jckpt._flatten(jp).items()}
    tflat = {k: v.shape for k, v in tckpt._flatten(tp).items()}
    assert tflat == jflat


def test_init_generator_is_seeded_and_device_independent():
    cfg = tcfgs.bench()
    a = tgan.init_generator(torch.Generator().manual_seed(3), cfg, "cpu")
    b = tgan.init_generator(torch.Generator().manual_seed(3), cfg, "cpu")
    c = tgan.init_generator(torch.Generator().manual_seed(4), cfg, "cpu")
    assert torch.equal(a["up0"]["w"], b["up0"]["w"])
    assert not torch.equal(a["up0"]["w"], c["up0"]["w"])


def test_convert_round_trip_is_exact():
    jp = _jax_params(ROUTES["lax"][0], seed=2)
    back = generator_to_numpy(generator_from_numpy(jp, "cpu"))
    flat_j, flat_b = jckpt._flatten(jp), tckpt._flatten(back)
    assert sorted(flat_j) == sorted(flat_b)
    for k in flat_j:
        assert flat_b[k].dtype == np.float32
        np.testing.assert_array_equal(flat_b[k], flat_j[k])


def test_jax_checkpoint_restores_in_port(tmp_path):
    """A generator saved by the JAX `checkpoint.save` (what
    `launch/train.py --ckpt` writes) restores through the port's
    `restore_gan_generator` to the same parameters and the same showers."""
    jcfg, tcfg = ROUTES["lax"]
    jp = _jax_params(jcfg, seed=5)
    jckpt.save(str(tmp_path), jp, step=7, extra={"precision": "bf16"})
    tp = tckpt.restore_gan_generator(str(tmp_path), tcfg, "cpu")
    assert tckpt.latest_step(str(tmp_path)) == 7
    assert tckpt.manifest_precision(str(tmp_path)) == "bf16"
    noise, e_p, theta = _labels(2, jcfg.latent_dim, seed=1)
    np.testing.assert_array_equal(
        _port_generate(tp, noise, e_p, theta, tcfg),
        _port_generate(generator_from_numpy(jp, "cpu"), noise, e_p, theta,
                       tcfg))


def test_port_checkpoint_restores_in_jax(tmp_path):
    jcfg, tcfg = ROUTES["lax"]
    tp = tgan.init_generator(torch.Generator().manual_seed(1), tcfg, "cpu")
    tckpt.save(str(tmp_path), tp, step=3)
    jp = jckpt.restore_gan_generator(str(tmp_path), jcfg)
    assert jckpt.manifest_precision(str(tmp_path)) == "f32"
    flat_t, flat_j = tckpt._flatten(tp), jckpt._flatten(jax.device_get(jp))
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_t:
        np.testing.assert_array_equal(flat_j[k], flat_t[k])


def test_restore_is_strict(tmp_path):
    tp = tgan.init_generator(torch.Generator().manual_seed(1),
                             tcfgs.bench(), "cpu")
    tckpt.save(str(tmp_path), tp)
    with pytest.raises(ValueError, match="ckpt"):
        tckpt.restore_gan_generator(str(tmp_path), tcfgs.reduced(), "cpu")
    del tp["up0"]["gn"]
    tckpt.save(str(tmp_path / "less"), tp)
    with pytest.raises(ValueError, match="missing from checkpoint"):
        tckpt.restore_gan_generator(str(tmp_path / "less"), tcfgs.bench(),
                                    "cpu")
