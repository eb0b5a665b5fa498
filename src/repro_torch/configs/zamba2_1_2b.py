"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block.
[arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        arch_id="zamba2-1.2b",
        family="hybrid",
        n_layers=38,                # mamba2 blocks
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,                  # shared-block MLP width
        vocab=32_000,
        source="arXiv:2411.15242",
        ffn_type="gelu",
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2),
        shared_attn_every=6,        # shared attn block applied every 6 layers
    )
