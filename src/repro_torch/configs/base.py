"""Architecture configuration of the port's language models: the
reference's ``configs/base.py`` registry, and its ``ArchConfig`` cut to
the fields of the dense and hybrid (Zamba2) families.

Every architecture is one frozen dataclass, registered by id.  Only the
ids with a config module in ``repro_torch/configs`` load here; the others
raise, naming the module they wait for.  ``calo3dgan`` keeps its own
module (``configs/calo3dgan.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # N (SSD state size per head)
    head_dim: int = 64           # P (channels per SSM head)
    expand: int = 2              # d_inner = expand * d_model
    conv_width: int = 4          # short causal conv width


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Config for one architecture: the reference's fields that the dense
    path (``models/lm.check_supported`` names what it runs) and the hybrid
    training path (``models/zamba.py``) read."""

    arch_id: str
    family: str                  # "dense" and "hybrid" are ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""             # citation (arXiv id / model card)

    # attention details
    d_head: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0      # 0 -> full causal attention

    # ffn details
    ffn_type: str = "swiglu"
    norm_type: str = "rmsnorm"
    tie_embeddings: bool = False

    # family extensions
    ssm: Optional[SSMConfig] = None

    # hybrid (zamba2): one shared attention block applied every k layers
    shared_attn_every: int = 0

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head


ARCH_IDS = (
    "whisper-base",
    "dbrx-132b",
    "qwen2-vl-72b",
    "granite-20b",
    "nemotron-4-15b",
    "zamba2-1.2b",
    "olmoe-1b-7b",
    "xlstm-125m",
    "qwen2-1.5b",
    "phi4-mini-3.8b",
    "calo3dgan",                 # the paper's own architecture
)

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MODULE_FOR)}")
    name = f"repro_torch.configs.{_MODULE_FOR[arch_id]}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise NotImplementedError(
            f"arch '{arch_id}' is not ported yet: no module {name} "
            "(see ROADMAP.md)") from None


def get_config(arch_id: str):
    return _module(arch_id).config()


def reduced_config(arch_id: str):
    """Reduced (smoke-test) variant of the same family: <=2 layers,
    d_model<=512 (the reference's rule for the dense family, and its
    ssm/hybrid additions: state 32, head 32, the shared block every 2
    layers; its chunk of 64 has no field here, see ``kernels/ssm_scan/ops``)."""
    mod = _module(arch_id)
    if hasattr(mod, "reduced"):
        return mod.reduced()
    c = mod.config()
    kw = dict(n_layers=2, d_model=256, n_heads=4,
              n_kv_heads=min(c.n_kv_heads, 4) if c.n_kv_heads > 1 else 1,
              d_head=64, d_ff=512 if c.d_ff else 0, vocab=512)
    if c.ssm is not None:
        kw["ssm"] = dataclasses.replace(c.ssm, state_dim=32, head_dim=32)
    if c.shared_attn_every:
        kw["shared_attn_every"] = 2
    return dataclasses.replace(c, **kw)
