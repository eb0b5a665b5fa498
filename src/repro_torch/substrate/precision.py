"""Mixed-precision policies: f32 master params, compute in ``compute_dtype``,
results in ``output_dtype``.  Loss scaling belongs to training and is not
part of the serving slice."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


DEFAULT = Policy()                                    # bf16 compute
FULL = Policy(compute_dtype=torch.float32)            # f32 everywhere
FP16 = Policy(compute_dtype=torch.float16)


def get_policy(name: str) -> Policy:
    return {"bf16": DEFAULT, "mixed": DEFAULT, "f32": FULL, "full": FULL,
            "fp16": FP16}[name]


def policy_name(policy: Policy) -> str:
    """Canonical name for a policy (the inverse of :func:`get_policy`)."""
    return {torch.bfloat16: "bf16", torch.float32: "f32",
            torch.float16: "fp16"}[policy.compute_dtype]
