"""The fit's products under matmul_precision (JAX package api.py:76-78):
the one place that decides whether a product runs as one bf16 pass, and
computes it.

The JAX package runs its init, its iterations and its .R replay inside
jax.default_matmul_precision(cfg.matmul_precision) (engine.py:175, 205,
611, 685). Under "default" every dot there takes its f32 operands as one
bf16-input pass with fp32 accumulation and an f32 result on the TPU, and
computes in f32 on the CPU. The E-step kernels do that in their one-pass
variant (ops/cuda/fused_estep.py). The torch products around them (k-means
init, the init pass, the stored iteration's centroid numerator, the
replays' and the stored ridge, the per-cell fit) go through `matmul` and
`einsum` here, with the `one` that engine.fit decides once per fit
(runs_one_pass of cfg and the data's device) and passes down:

  one False         today's op (`a @ b`, `torch.einsum`), bit for bit;
  one, on a card    each operand rounded to bf16 (to nearest even) and one
                    cuBLAS bf16 product with fp32 accumulation and an fp32
                    result (torch.mm / torch.bmm with out_dtype); the
                    einsums as bmm over explicit layouts;
  one, on the CPU   the plain version (`matmul_plain`, `einsum_plain`):
                    both operands through `plain_operand` (round_bf16),
                    the fp32 product.

The result is fp32, never bf16: dist = 2 (1 - Y^T z) cancels near 1, and a
bf16 result would quantize it in steps of ~2^-7. No process-wide setting
(torch.set_float32_matmul_precision, TF32, autocast) is touched, so LISI's
products and the caller's stay as they were. A card's torch without
out_dtype products fails the fit and says so; nothing falls back to fp32.
"""

from __future__ import annotations

import math

import torch

PRECISIONS = ("default", "float32")


def one_pass(precision: str) -> bool:
    """Whether `precision` runs the one-pass products on a card."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return precision == "default"


def runs_one_pass(cfg, device) -> bool:
    """Whether cfg's fit runs the one-pass products (the kernels' and the
    torch ones) on `device`: matmul_precision "default" on a CUDA card (the
    CPU computes in fp32)."""
    return (one_pass(cfg.matmul_precision)
            and torch.device(device).type == "cuda")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest bf16, ties to even, as float32:
    the rounding of the kernels' one-pass operands (__float2bfloat16_rn),
    on the bits: add 0x7fff plus the kept part's lowest bit, clear the low
    16 bits (finite x; an overflow rounds to infinity)."""
    u = x.contiguous().view(torch.int32)
    u = (u + (0x7FFF + ((u >> 16) & 1))) & -0x10000
    return u.view(torch.float32)


def _on_card(name: str, fn, a, b):
    try:
        return fn(a, b, out_dtype=torch.float32)
    except (TypeError, NotImplementedError) as e:
        raise RuntimeError(
            f"matmul_precision='default' needs torch.{name}(..., "
            f"out_dtype=torch.float32) on bf16 operands on the card, which "
            f"this torch {torch.__version__} lacks: {e}") from e


def matmul_plain(a, b) -> torch.Tensor:
    """The plain one-pass version of a @ b: both operands rounded to bf16,
    the product in fp32."""
    return plain_operand(a, True) @ plain_operand(b, True)


def matmul(a, b, one: bool) -> torch.Tensor:
    """a @ b of a 2-D (or 1-D) a and a 2-D b; with `one` as one bf16 pass
    (see the module docstring)."""
    if not one:
        return a @ b
    if a.device.type != "cuda":
        return matmul_plain(a, b)
    a2 = a[None] if a.dim() == 1 else a
    out = _on_card("mm", torch.mm, a2.to(torch.bfloat16),
                   b.to(torch.bfloat16))
    return out[0] if a.dim() == 1 else out


def einsum_plain(eq: str, a, b) -> torch.Tensor:
    """The plain one-pass version of torch.einsum(eq, a, b): both operands
    rounded to bf16, the product in fp32."""
    return torch.einsum(eq, plain_operand(a, True), plain_operand(b, True))


def einsum(eq: str, a, b, one: bool) -> torch.Tensor:
    """torch.einsum(eq, a, b) of two operands; with `one` as one bf16 pass
    (see the module docstring)."""
    if not one:
        return torch.einsum(eq, a, b)
    if a.device.type != "cuda":
        return einsum_plain(eq, a, b)
    return einsum_bmm(eq, a.to(torch.bfloat16), b.to(torch.bfloat16),
                      lambda x, y: _on_card("bmm", torch.bmm, x, y))


def einsum_bmm(eq: str, a, b, bmm) -> torch.Tensor:
    """torch.einsum(eq, a, b) as one bmm(A, B) (A: batch x M x K, B: batch
    x K x N) over explicit layouts. Every index is a batch index (in both
    operands and the output), a contracted one (in both, not the output)
    or a free one (in one operand and the output). A leading output index
    that leads one operand only is a batch index the other operand is
    broadcast over (a stride-0 expand, no copy), as the E-step's
    Y^T z products are (ops/update_r_fused.block_core)."""
    ins, out = eq.split("->")
    sa, sb = ins.split(",")
    x = out[0]
    if sa[0] == x and x not in sb:
        sb, b = x + sb, b.unsqueeze(0).expand(a.shape[0], *b.shape)
    elif sb[0] == x and x not in sa:
        sa, a = x + sa, a.unsqueeze(0).expand(b.shape[0], *a.shape)
    size = dict(zip(sa, a.shape)) | dict(zip(sb, b.shape))
    batch = [c for c in out if c in sa and c in sb]
    con = [c for c in sa if c in sb and c not in out]
    fa = [c for c in sa if c not in sb]
    fb = [c for c in sb if c not in sa]
    if sorted(batch + fa + fb) != sorted(out):
        raise ValueError(f"einsum_bmm: {eq!r} reduces an index of one "
                         f"operand")

    def n(cs):
        return math.prod(size[c] for c in cs)

    A = a.permute([sa.index(c) for c in batch + fa + con]).reshape(
        n(batch), n(fa), n(con))
    B = b.permute([sb.index(c) for c in batch + con + fb]).reshape(
        n(batch), n(con), n(fb))
    C = bmm(A, B).reshape([size[c] for c in batch + fa + fb])
    return C.permute([(batch + fa + fb).index(c) for c in out])


def plain_operand(x, one: bool) -> torch.Tensor:
    """x as the plain one-pass version takes it: round_bf16(x) with `one`,
    else x. The plain versions here and of the E-step kernels
    (ops/update_r_fused.py) round their operands through it."""
    return round_bf16(x) if one else x


def operand(x, one: bool) -> torch.Tensor:
    """x as a one-pass product takes it, for an operand that several
    products share: bf16 on a card, the plain version's elsewhere.
    `matmul` / `einsum` take it as they take x, with the same bits."""
    if one and x.device.type == "cuda":
        return x.to(torch.bfloat16)
    return plain_operand(x, one)
