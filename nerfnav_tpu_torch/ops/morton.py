"""Occupancy bit-packing: byte bitfields and block-packed rows.

Counterpart of nerfnav_tpu/ops/morton.py (the packing half). Row layouts and
bit orders match the reference bit for bit. Block rows are uint32 words in
the reference; here they are carried in int64 tensors (torch.uint32 lacks
most operations), each holding a value in [0, 2^32). The weight bridge
(training/checkpoint.py) converts at the boundary.
"""

import torch


def packbits(occupied: torch.Tensor) -> torch.Tensor:
    """(..., 8*m) bool/float occupancy -> (..., m) uint8 bitfield; bit k of
    byte j covers cell 8*j + k (LSB first)."""
    bits = (occupied > 0).long().reshape(*occupied.shape[:-1], -1, 8)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], device=occupied.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def unpackbits(bitfield: torch.Tensor, n_bits=None) -> torch.Tensor:
    """Inverse of packbits: (..., m) uint8 -> (..., 8*m) bool."""
    shifts = torch.arange(8, device=bitfield.device)
    bits = (bitfield.long()[..., None] >> shifts) & 1
    out = bits.reshape(*bitfield.shape[:-1], -1).bool()
    if n_bits is not None:
        out = out[..., :n_bits]
    return out


def pack_blocks(occupied: torch.Tensor, grid_size: int, block: int = 4):
    """Pack a (..., H^3) row-major occupancy grid into block rows.

    Returns (..., (H/block)^3, block^3/32) int64 words in [0, 2^32): row b
    holds one block^3 tile of cells, local bit ((lx*block) + ly)*block + lz,
    LSB first across consecutive words."""
    words = block**3 // 32
    if words * 32 != block**3:
        raise ValueError("block^3 must be a multiple of 32")
    h, b = grid_size, block
    nb = h // b
    if nb * b != h:
        raise ValueError("grid_size must be divisible by block")
    lead = occupied.shape[:-1]
    occ = (occupied > 0).reshape(*lead, nb, b, nb, b, nb, b)
    nd = occ.dim()
    perm = tuple(range(nd - 6)) + tuple(nd - 6 + i for i in (0, 2, 4, 1, 3, 5))
    occ = occ.permute(perm).reshape(*lead, nb**3, words, 32)
    shifts = torch.arange(32, device=occupied.device)
    return (occ.long() << shifts).sum(dim=-1)


def block_size_of(rows) -> int:
    """Cells per axis of the block a pack_blocks table was packed with."""
    return round((rows.shape[-1] * 32) ** (1.0 / 3.0))


def block_bit_lookup(rows: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """rows: (..., W) block words (broadcastable against local's shape);
    local: (...,) int in [0, 32*W). Returns the bool occupancy bits."""
    local = local.long()
    shape = torch.broadcast_shapes(rows.shape[:-1], local.shape)
    rows_b = rows.expand(*shape, rows.shape[-1])
    word = torch.gather(rows_b, -1, (local >> 5).expand(shape)[..., None])[..., 0]
    return ((word >> (local & 31)) & 1).bool()


def unpack_blocks(rows: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Inverse of pack_blocks: (..., (H/b)^3, W) -> (..., H^3) bool."""
    b = block_size_of(rows)
    h = grid_size
    nb = h // b
    if nb * b != h or nb**3 != rows.shape[-2]:
        raise ValueError(f"rows {tuple(rows.shape)} do not pack a {h}^3 grid")
    lead = rows.shape[:-2]
    shifts = torch.arange(32, device=rows.device)
    bits = (rows[..., None] >> shifts) & 1
    bits = bits.reshape(*lead, nb, nb, nb, b, b, b)
    nd = bits.dim()
    perm = tuple(range(nd - 6)) + tuple(nd - 6 + i for i in (0, 3, 1, 4, 2, 5))
    return bits.permute(perm).reshape(*lead, h**3).bool()
