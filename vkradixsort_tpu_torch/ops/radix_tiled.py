"""The radix pipeline: VkRadixSort's multi_radixsort, and the card's
onesweep sort.

Port of ``vkradixsort_tpu/ops/radix_tiled.py``. Its API, per 8-bit digit
pass, as the reference's two shaders per pass do:

  1. ``histogram.tile_histograms``: per-tile digit counts (kernel
     ``csrc/histogram.cu``);
  2. ``reference.exclusive_bin_offsets``: the global scan of the
     ``[num_tiles, 256]`` table, in torch (XLA did it in the JAX package);
  3. ``tile_scatter``: each element ranked among the equal digits of its
     tile and moved, with its payload, to its tile's base for its digit plus
     that rank (kernel ``csrc/radix_dest.cu``, scatter mode), where the JAX
     package computed the destinations in its kernel and left the move to
     XLA.

``tile_destinations`` is the same kernel's destination mode: it writes the
destinations and moves nothing (JAX's ``pass_destinations``). No sort runs
those passes; the tests hold the onesweep pass against them.

``sort_radix_tiled`` runs ``sort_onesweep`` (kernels ``csrc/onesweep.cu``)
on every device: one ``histogram.digit_histograms`` a sort, which counts
every pass's digits in one read of the keys and scans them, then one
``onesweep_pass`` a pass, whose tiles find their bases by decoupled
look-back, so the table and its scan never exist and the kernels' tiles are
their own (``onesweep_shape``). Each kernel wrapper takes its plain version
only for a CPU tensor. Destinations and offsets are int32, as in JAX, so the
pipeline takes n < 2^31 (``accepts``).

``sort_radix_tiled`` takes a payload set too, where the JAX engine takes one
payload: one payload that fits a 512-thread pass with its key rides the
passes; any other set rides as u32 positions, and ``gather.gather_columns``
(kernel ``csrc/gather.cu``) moves every payload through the sorted positions
in one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vkradixsort_tpu_torch.ops import gather, histogram, kernels, reference
from vkradixsort_tpu_torch.ops.common import (
    BITS_PER_PASS,
    NUM_BINS,
    cdiv,
    extract_digit,
    num_passes,
    positions,
)
from vkradixsort_tpu_torch.utils import profiling

PAYLOAD_BYTES = (1, 2, 4, 8)  # payload widths the scatter kernel moves
# sort_radix_tiled carries one payload through the passes while key and
# payload bytes together are at most this (the pass kernel's 512-thread
# instances); any other payload set rides as u32 positions and is gathered
# after them. H100, 1e8 uniform keys (PERF.md): u32 keys carry every width
# (8-byte payload 4.71 against 7.16 ms); u64 keys carry 1, 2 and 4 bytes
# (4: 9.43 against 12.77) and gather 8 (13.01 against 13.81; 2^24: 2.265
# against 2.514)
CARRY_MAX_BYTES = 12


def accepts(n: int, vals: tuple) -> bool:
    """Whether radix_tiled sorts ``n`` keys carrying the payloads ``vals``:
    its destinations and offsets are int32, so n < 2^31, and its kernels move
    payloads of :data:`PAYLOAD_BYTES` bytes."""
    return n < 1 << 31 and all(v.element_size() in PAYLOAD_BYTES for v in vals)


def _check_input(enc: torch.Tensor, shift: int, tile: int) -> None:
    histogram.check_digit_input(enc, shift, tile)
    if not accepts(enc.shape[0], ()):
        raise ValueError(
            f"radix_tiled destinations are int32, so n must be below 2^31; got {enc.shape[0]}"
        )


def _check_base(enc: torch.Tensor, tile: int, base: torch.Tensor) -> None:
    n = enc.shape[0]
    if base.dtype != torch.int32 or tuple(base.shape) != (cdiv(n, tile), NUM_BINS):
        raise ValueError(f"base must be [{cdiv(n, tile)}, {NUM_BINS}] int32, got "
                         f"{base.dtype} {tuple(base.shape)}")
    if enc.device.type != "cpu" and (base.device != enc.device or not base.is_contiguous()):
        raise ValueError("base must be contiguous and on the keys' device")


def _check_move(enc: torch.Tensor, values) -> None:
    if values is not None:
        if values.shape != enc.shape or values.device != enc.device:
            raise ValueError("values must have the keys' shape and device")
        if not accepts(0, (values,)):
            raise TypeError(f"radix_tiled moves payloads of {PAYLOAD_BYTES} bytes, "
                            f"got {values.dtype}")


def tile_destinations_plain(enc: torch.Tensor, shift: int, tile: int,
                            base: torch.Tensor) -> torch.Tensor:
    """Plain version of the destination mode: ``base[tile, digit]`` plus
    the stable in-tile rank, from a stable sort of each tile's digits (the
    ragged last tile is padded with digit 256, which ranks after every real
    digit)."""
    n = enc.shape[0]
    nt = cdiv(n, tile)
    digits = extract_digit(enc, shift)
    padded = torch.full((nt * tile,), NUM_BINS, dtype=torch.int32, device=enc.device)
    padded[:n] = digits
    rank = reference.rank_in_chunk(padded.view(nt, tile)).view(-1)[:n]
    tile_id = torch.arange(n, device=enc.device) // tile
    return base.reshape(-1)[tile_id * NUM_BINS + digits] + rank


def tile_destinations(enc: torch.Tensor, shift: int, tile: int,
                      base: torch.Tensor) -> torch.Tensor:
    """int32 ``dest[i] = base[i // tile, d_i] + #(earlier j in the tile with
    d_j = d_i)``, ``d_i = (enc[i] >> shift) & 0xFF``; ``base`` is the
    ``[cdiv(n, tile), 256]`` int32 table of ``exclusive_bin_offsets``."""
    _check_input(enc, shift, tile)
    _check_base(enc, tile, base)
    if enc.device.type == "cpu":
        return tile_destinations_plain(enc, shift, tile, base)
    x, stride, sh = histogram.digit_half(enc, shift)
    n = enc.shape[0]
    dest = torch.empty(n, dtype=torch.int32, device=enc.device)
    if n:
        kernels.call("radix_dest", enc.device, x.data_ptr(), n, stride, sh, tile,
                     base.data_ptr(), dest.data_ptr())
        profiling.count("launch.tile_destinations")
    return dest


def tile_scatter_plain(enc: torch.Tensor, values, shift: int, tile: int, base: torch.Tensor):
    """Plain version of the scatter mode: the plain destinations, widened to
    int64 for torch's indexing, then a scatter of the keys and ``values``
    (or None)."""
    dest = tile_destinations_plain(enc, shift, tile, base).to(torch.int64)
    out_v = None if values is None else reference.scatter(values, dest)
    return reference.scatter(enc, dest), out_v


def tile_scatter(enc: torch.Tensor, values, shift: int, tile: int, base: torch.Tensor):
    """Keys and ``values`` (or None) moved to the destinations
    :func:`tile_destinations` gives, in one kernel that ranks and moves:
    ``(out_keys, out_values)``. ``values``: one payload of 1, 2, 4 or 8
    bytes an element, the keys' length. The inputs are not modified."""
    _check_input(enc, shift, tile)
    _check_base(enc, tile, base)
    _check_move(enc, values)
    if enc.device.type == "cpu":
        return tile_scatter_plain(enc, values, shift, tile, base)
    if enc.device.type != "cuda":
        raise ValueError(f"the radix kernels run on CUDA tensors, got {enc.device}")
    if not enc.is_contiguous() or (values is not None and not values.is_contiguous()):
        raise ValueError("the scatter kernel takes contiguous keys and values")
    n = enc.shape[0]
    out_k = torch.empty_like(enc)
    out_v = None if values is None else torch.empty_like(values)
    if n:
        kernels.call("radix_scatter", enc.device, enc.data_ptr(), enc.element_size(),
                     0 if values is None else values.data_ptr(),
                     0 if values is None else values.element_size(), n, shift, tile,
                     base.data_ptr(), out_k.data_ptr(), 0 if out_v is None else out_v.data_ptr())
        profiling.count("launch.tile_scatter")
    return out_k, out_v


def pass_destinations_plain(enc: torch.Tensor, shift: int, tile: int = histogram.TILE):
    """Plain version of :func:`pass_destinations`: the plain histogram, the
    scan, the plain destinations."""
    base = reference.exclusive_bin_offsets(histogram.tile_histograms_plain(enc, shift, tile))
    return tile_destinations_plain(enc, shift, tile, base)


def pass_destinations(enc: torch.Tensor, shift: int, tile: int = histogram.TILE) -> torch.Tensor:
    """Global int32 scatter destination of every element for the stable
    pass over the digit ``(enc >> shift) & 0xFF``: histogram, scan,
    destinations."""
    _check_input(enc, shift, tile)
    base = reference.exclusive_bin_offsets(histogram.tile_histograms(enc, shift, tile))
    return tile_destinations(enc, shift, tile, base)


def radix_pass_tiled(enc: torch.Tensor, values, shift: int, tile: int = histogram.TILE):
    """One stable radix pass of the keys and ``values`` (or None): the
    histogram, the scan, then the rank and the move in one kernel, each in
    its span (``vkrs/radix/histogram``, ``scan``, ``scatter``). Returns
    ``(out_keys, out_values)``."""
    _check_input(enc, shift, tile)
    with profiling.span("vkrs/radix/histogram"):
        hist = histogram.tile_histograms(enc, shift, tile)
    with profiling.span("vkrs/radix/scan"):
        base = reference.exclusive_bin_offsets(hist)
    del hist  # free the counts before the scatter allocates its outputs
    with profiling.span("vkrs/radix/scatter"):
        return tile_scatter(enc, values, shift, tile, base)


def lookback_bases_plain(enc: torch.Tensor, shift: int, tile: int,
                         offset: torch.Tensor) -> torch.Tensor:
    """What the onesweep pass's look-back gives tile t for digit d: the
    pass's ``offset[d]`` plus the count of digit d in tiles before t, as a
    ``[cdiv(n, tile), 256]`` int32 table (``exclusive_bin_offsets`` of the
    tiles' counts)."""
    counts = histogram.tile_histograms_plain(enc, shift, tile)
    return offset + torch.cumsum(counts, 0, dtype=torch.int32) - counts


def onesweep_pass_plain(enc: torch.Tensor, values, shift: int, offset: torch.Tensor,
                        tile: int = histogram.TILE):
    """Plain version of :func:`onesweep_pass`: the counts per tile, their
    cumsum over tiles plus ``offset``, then the plain move. The result does
    not depend on ``tile``."""
    return tile_scatter_plain(enc, values, shift, tile,
                              lookback_bases_plain(enc, shift, tile, offset))


@functools.lru_cache(maxsize=None)
def onesweep_shape(device_index: int, key_bytes: int, val_bytes: int) -> dict:
    """The onesweep pass kernel's shape for these widths on a CUDA device:
    ``threads``, ``per_thread`` (elements a thread), ``tile`` (their
    product: the elements of one block and of one row of look-back words)
    and ``blocks_per_sm`` (how many fit an SM)."""
    shape = (ctypes.c_int * 4)()
    lib = kernels.load()
    err = lib.vkrs_onesweep_shape(device_index, key_bytes, val_bytes, shape)
    if err != 0:
        raise RuntimeError(f"vkrs_onesweep_shape failed: {lib.vkrs_error_string(err).decode()} "
                           f"(cudaError {err})")
    return dict(zip(("threads", "per_thread", "tile", "blocks_per_sm"), shape))


def _lookback_words(enc: torch.Tensor, values) -> int:
    width = 0 if values is None else values.element_size()
    tile = onesweep_shape(enc.device.index, enc.element_size(), width)["tile"]
    return cdiv(enc.shape[0], tile) * NUM_BINS + 1


def lookback_state(enc: torch.Tensor, values) -> torch.Tensor:
    """The onesweep passes' look-back words and tile counter for these keys
    and ``values`` (or None) on their CUDA device: int32, one word a tile and
    digit and one more, uninitialized (each pass zeroes them). One state
    serves every pass of a sort."""
    return torch.empty(_lookback_words(enc, values), dtype=torch.int32, device=enc.device)


def onesweep_pass(enc: torch.Tensor, values, shift: int, offset: torch.Tensor, state=None):
    """One stable radix pass of the keys and ``values`` (or None) over the
    digit ``(enc >> shift) & 0xFF``, in one kernel that ranks each tile,
    finds its bases by look-back and moves keys and payload:
    ``(out_keys, out_values)``. ``offset``: the pass's 256 int32 first
    slots, a row of :func:`histogram.digit_histograms`; ``state``: the
    :func:`lookback_state` of these keys and values (allocated when None).
    The inputs are not modified."""
    _check_input(enc, shift, 1)
    _check_move(enc, values)
    if offset.dtype != torch.int32 or tuple(offset.shape) != (NUM_BINS,):
        raise ValueError(f"offset must be [{NUM_BINS}] int32, got {offset.dtype} "
                         f"{tuple(offset.shape)}")
    if enc.device.type == "cpu":
        return onesweep_pass_plain(enc, values, shift, offset)
    if enc.device.type != "cuda":
        raise ValueError(f"the radix kernels run on CUDA tensors, got {enc.device}")
    if not enc.is_contiguous() or (values is not None and not values.is_contiguous()):
        raise ValueError("the onesweep kernel takes contiguous keys and values")
    if offset.device != enc.device or not offset.is_contiguous():
        raise ValueError("offset must be contiguous and on the keys' device")
    if state is None:
        state = lookback_state(enc, values)
    elif (state.dtype != torch.int32 or state.device != enc.device
          or state.numel() != _lookback_words(enc, values)):
        raise ValueError("state must be the lookback_state of these keys and values")
    n = enc.shape[0]
    out_k = torch.empty_like(enc)
    out_v = None if values is None else torch.empty_like(values)
    if n:
        kernels.call("onesweep_pass", enc.device, enc.data_ptr(), enc.element_size(),
                     0 if values is None else values.data_ptr(),
                     0 if values is None else values.element_size(), n, shift,
                     offset.data_ptr(), state.data_ptr(), out_k.data_ptr(),
                     0 if out_v is None else out_v.data_ptr())
        profiling.count("launch.onesweep_pass")
    return out_k, out_v


def sort_onesweep(enc: torch.Tensor, values=None):
    """Full stable LSD sort of uint32/uint64 encoded keys, carrying one
    payload (or None), as the card runs it: the digits of every pass counted
    and scanned once (span ``vkrs/radix/histogram``), then one onesweep
    pass a digit (``vkrs/radix/scatter``), 4 for u32 and 8 for u64, all on
    one look-back state. On CPU tensors the plain versions. Returns
    ``(sorted_keys, sorted_values)``; the inputs are not modified."""
    with profiling.span("vkrs/radix/histogram"):
        offsets = histogram.digit_histograms(enc)
    state = None if enc.device.type == "cpu" else lookback_state(enc, values)
    for p in range(num_passes(enc.dtype)):
        with profiling.span("vkrs/radix/scatter"):
            enc, values = onesweep_pass(enc, values, p * BITS_PER_PASS, offsets[p], state)
    return enc, values


def carries(enc: torch.Tensor, value: torch.Tensor) -> bool:
    """Whether :func:`sort_radix_tiled` carries ``value``, a single payload,
    through the passes (else it sorts positions and gathers)."""
    return enc.element_size() + value.element_size() <= CARRY_MAX_BYTES


def sort_radix_tiled(enc: torch.Tensor, values=None):
    """Full stable LSD sort of uint32/uint64 encoded keys by
    :func:`sort_onesweep`: 4 passes for u32, 8 for u64.

    ``values``: None, one payload, or a tuple of payloads, each of 1, 2, 4
    or 8 bytes an element and the keys' length. No payload, or one that with
    the key spans at most :data:`CARRY_MAX_BYTES`, rides the passes; any
    other set is moved after them: the keys are sorted carrying their u32
    positions, and ``gather.gather_columns`` moves every payload through
    the sorted positions (span ``vkrs/radix/gather``; on a CPU tensor the
    plain indexing). Returns ``(sorted_keys, sorted_values)``, the values as
    they were passed (None, a tensor or a tuple); the inputs are not
    modified."""
    _check_input(enc, 0, 1)
    multi = isinstance(values, tuple)
    vals = values if multi else (() if values is None else (values,))
    for v in vals:
        _check_move(enc, v)
    enc = enc.contiguous()
    vals = tuple(v.contiguous() for v in vals)
    if enc.shape[0] <= 1:
        out_k, out_vs = enc.clone(), tuple(v.clone() for v in vals)
    elif len(vals) > 1 or (vals and not carries(enc, vals[0])):
        out_k, perm = sort_onesweep(enc, positions(enc.shape[0], enc.device))
        with profiling.span("vkrs/radix/gather"):
            out_vs = gather.gather_columns(perm, vals)
    else:
        out_k, out_v = sort_onesweep(enc, vals[0] if vals else None)
        out_vs = (out_v,) if vals else ()
    if multi:
        return out_k, out_vs
    return out_k, out_vs[0] if out_vs else None
