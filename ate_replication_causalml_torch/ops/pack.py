"""Packed bin codes: three 7-bit codes per int32 word.

Port of ``ate_replication_causalml_tpu/ops/pack.py`` with the same
names, policy and errors. Every code is below ``n_bins`` ≤ 128, i.e. 7
bits, so three fit one word::

    word = c0 + 128·c1 + 128²·c2          (word < 2^21)

with feature f in word ``f // 3``, slot ``f % 3``. The JAX package holds
the word in a float32 (exact below the 24-bit mantissa) because its
consumers are matrix products; the port holds the same integer as
int32 and extracts a slot with a shift and a mask. For every int32 word
``(word >> 7s) & 127`` equals the JAX package's
``floor(word / 128^s) mod 128``, so the two agree exactly.

The consumer is the partition histogram's packed pass
(``ops/hist.py``, ``mode="partition+pack"``): each permuted row's word is
read once and split into its three features. The words are built once
per forest fit by :func:`pack_codes` (``csrc/hist_partition.cu``'s
``pack_words`` kernel on the card). The JAX package's other consumer,
packed routing (``route_rows_packed``), is an XLA contraction with the
same leaves; the port routes with its route kernel either way.

Policy: :func:`resolve_predict_pack` reads ``ATE_TPU_PREDICT_PACK``
("0" | "1" | "auto", case-insensitive, default "auto" = unpacked), as
the JAX package does; a bad value raises.
"""

from __future__ import annotations

import os

import torch

from ate_replication_causalml_torch.kernels import build

ENV_PACK = "ATE_TPU_PREDICT_PACK"
PACK_MODES = ("0", "1", "auto")

#: Codes per packed word and the per-slot radix (7 bits: codes < 128).
PACK_SLOTS = 3
PACK_RADIX = 128
_SLOT_BITS = 7


def resolve_predict_pack(pack: bool | str | None = None) -> bool:
    """The config-time entry of the packed-code policy: ``pack`` (a bool
    or a mode string) when given, else ``ATE_TPU_PREDICT_PACK`` (default
    "auto", which resolves to unpacked). A bad value raises here."""
    if isinstance(pack, bool):
        return pack
    raw = pack if pack is not None else os.environ.get(ENV_PACK, "auto")
    val = str(raw).strip().lower()
    if val not in PACK_MODES:
        raise ValueError(
            f"{ENV_PACK}/pack must be one of {PACK_MODES} "
            f"(case-insensitive) or a bool, got {raw!r}"
        )
    return val == "1"


def packable(n_bins: int) -> bool:
    """Whether codes of an ``n_bins``-bin quantization fit a 7-bit slot
    (``n_bins`` ≤ 128); callers keep the unpacked path otherwise."""
    return int(n_bins) <= PACK_RADIX


def packed_width(p: int) -> int:
    """Packed column count: ``ceil(p / 3)``."""
    return -(-int(p) // PACK_SLOTS)


def pack_codes_plain(codes: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`pack_codes`."""
    rows, p = codes.shape
    p3 = packed_width(p)
    c = torch.nn.functional.pad(codes.to(torch.int32), (0, p3 * PACK_SLOTS - p))
    c = c.reshape(rows, p3, PACK_SLOTS)
    return c[:, :, 0] + PACK_RADIX * c[:, :, 1] + PACK_RADIX * PACK_RADIX * c[:, :, 2]


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(rows, p) int32 bin codes < 128 → (rows, ceil(p/3)) int32 words;
    feature f lands in word ``f // 3``, slot ``f % 3``; missing trailing
    slots pack as 0. On a CUDA tensor this launches the ``pack_words``
    kernel (counted in ``pack_codes.launches``); on a CPU tensor it runs
    :func:`pack_codes_plain`."""
    if codes.dtype != torch.int32 or codes.ndim != 2:
        raise TypeError(f"codes must be (n, p) int32, got {codes.dtype} {tuple(codes.shape)}")
    if codes.device.type == "cpu":
        return pack_codes_plain(codes)
    if codes.device.type != "cuda":
        raise ValueError(f"no pack kernel for device {codes.device}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    n, p = codes.shape
    words = torch.empty((n, packed_width(p)), dtype=torch.int32, device=codes.device)
    if words.numel() == 0:
        return words
    k = build.kernel("pack_codes")
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    build.check(k, k.fn(codes.data_ptr(), n, p, words.data_ptr(), stream))
    build.count_launch(pack_codes)
    return words


pack_codes.launches = 0


def extract_slot(word: torch.Tensor, slot) -> torch.Tensor:
    """The 7-bit code at ``slot`` (0, 1 or 2; an int or an integer
    tensor, broadcasting) of the int32 ``word``."""
    shift = torch.as_tensor(slot, device=word.device).to(torch.int32) * _SLOT_BITS
    return (word >> shift) & (PACK_RADIX - 1)


def unpack_codes(packed: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: (rows, ceil(p/3)) words → (rows, p)
    int32 codes."""
    rows, p3 = packed.shape
    out = torch.stack([extract_slot(packed, s) for s in range(PACK_SLOTS)], dim=2)
    return out.reshape(rows, p3 * PACK_SLOTS)[:, :p]
