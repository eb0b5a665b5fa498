"""calo3dgan: the paper's own architecture — 3-D convolutional ACGAN for
electromagnetic-calorimeter shower simulation (3DGAN, Khattak et al. 2019,
as trained in this paper).  A copy of the reference config; the port has
no kernel-routing toggle (a CUDA tensor always runs the kernel), so
``use_pallas_conv`` is kept only for config equality and nothing reads it.
"""
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GANConfig:
    arch_id: str = "calo3dgan"
    family: str = "gan"
    source: str = "18th IEEE ICMLA (2019); this paper"
    # calorimeter image: 51 x 51 x 25 cells (x, y, z=depth)
    image_shape: Tuple[int, int, int] = (51, 51, 25)
    latent_dim: int = 254          # + 2 conditioning scalars (E_p, theta)
    gen_channels: Tuple[int, ...] = (64, 32, 16, 8)
    disc_channels: Tuple[int, ...] = (16, 32, 64, 128)
    gen_steps_per_disc: int = 2    # Algorithm 1: train G twice per D step
    # ACGAN auxiliary targets: primary energy E_p, angle theta, total E_CAL
    aux_ecal_weight: float = 0.1
    aux_energy_weight: float = 10.0
    aux_angle_weight: float = 0.1
    batch_size: int = 128
    decode_supported: bool = False
    use_pallas_conv: Optional[bool] = None
    # mixed-precision policy name (substrate/precision.get_policy)
    precision: str = "bf16"
    grad_reduce: str = "flat"
    reduce_bucket_mb: float = 4.0


def config() -> GANConfig:
    return GANConfig()


def reduced() -> GANConfig:
    return GANConfig(
        image_shape=(13, 13, 13),
        latent_dim=62,
        gen_channels=(16, 8),
        disc_channels=(8, 16),
        batch_size=8,
    )


def bench() -> GANConfig:
    """Minimal variant for CPU runs."""
    return GANConfig(
        image_shape=(9, 9, 9),
        latent_dim=30,
        gen_channels=(12, 6),
        disc_channels=(6, 12),
        batch_size=8,
    )
