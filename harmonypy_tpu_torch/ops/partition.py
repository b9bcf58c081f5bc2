"""Chunk-to-block partition and fixed-order reductions, on one device or a
mesh of shards.

The fused E-step updates cells in contiguous CHUNKS of `chunk_size` cells.
Chunks are assigned to ceil(1/block_size) blocks through stripes of
`n_blocks` consecutive chunks: stripe s gets an independent random
permutation of the block ids. Each block therefore owns one chunk per
stripe, and its chunks are visited in ascending id order (JAX package
ops/partition.py:46-250).

The per-cell E-step assigns each CELL an iid-uniform block instead, with a
per-tile capacity rule (iid_blocks, JAX package ops/partition.py:86-118).

On a mesh, shard s holds the chunks s * nc_cap .. (s + 1) * nc_cap - 1
(global ids) and its own dummy chunk; the draws are global (the same
generator calls as on one device), and every reduction over chunks gathers
the shards' per-chunk rows into the global frame on the lead device and
reduces it there exactly as one device does (`frame_rows`, `frame_sum`): a
copy with no arithmetic, so the result is the one-device result bit for
bit (JAX package ops/partition.py:20-27, 237-250). Across processes the
frame is all-gathered, and every rank sums the same rows with the same
`torch.sum`: the same bits on every rank.

Where the JAX package draws from threefry keys, the port draws from a
`torch.Generator`; the two streams differ, so tests inject the JAX package's
`stripe_blocks` output through `round_tables(blocks, ...)`, and its iid draw
through `iid_blocks_from_draw`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..config import EngineConfig, cdiv, cell_tile_geom, round_up
from ..parallel.mesh import all_gather_rows, local_shards, spans_processes
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PartitionGeometry:
    NC_real: int    # ceil(N / CH): chunks containing real cells
    NC_fixed: int   # round_up(NC_real, nb): partition/reduction frame rows
    nc_cap: int     # chunk capacity (excluding the dummy chunk)
    L: int          # assignment-table length: max(NC_fixed, nc_cap)
    J_fix: int      # NC_fixed // nb: chunks per block
    J_shard: int    # slots per block in the slot table (ends in a dummy)
    nb: int         # number of blocks
    CH: int         # chunk size (cells)
    n_devices: int


def partition_geometry(cfg: EngineConfig) -> PartitionGeometry:
    CH, nb, D = cfg.chunk_size, cfg.n_blocks, cfg.n_devices
    NC_real = cdiv(cfg.N, CH)
    NC_fixed = round_up(NC_real, nb)
    nc_cap = cfg.N_local // CH - 1  # the last chunk is the dummy
    return PartitionGeometry(
        NC_real=NC_real, NC_fixed=NC_fixed, nc_cap=nc_cap,
        L=max(NC_fixed, D * nc_cap), J_fix=NC_fixed // nb,
        J_shard=cdiv(nc_cap, nb) + 1, nb=nb, CH=CH, n_devices=D)


def stripe_blocks(gen: torch.Generator, n_real: int, L: int,
                  nb: int) -> torch.Tensor:
    """(L,) int64 block assignment: item g < n_real gets block
    sigma_{g // nb}(g % nb), with one random permutation sigma_s of the block
    ids per stripe; items >= n_real get the sentinel block `nb`. Drawn on
    the generator's device. The draw covers the stripes of the n_real items
    only, so it does not depend on L (which grows with the mesh): the same
    seed gives the same blocks and leaves the generator in the same state on
    every mesh."""
    n_stripes = cdiv(n_real, nb)
    keys = torch.rand((n_stripes, nb), generator=gen, device=gen.device)
    blocks = torch.argsort(keys, dim=1, stable=True).reshape(-1)
    if blocks.shape[0] < L:
        blocks = torch.cat([blocks, blocks.new_full((L - blocks.shape[0],),
                                                    nb)])
    blocks = blocks[:L]
    ids = torch.arange(L, device=blocks.device)
    return torch.where(ids < n_real, blocks, torch.full_like(blocks, nb))


def iid_blocks(gen: torch.Generator, n_real: int, L: int,
               nb: int) -> torch.Tensor:
    """(L,) int64 iid-uniform block per cell, items >= n_real and capacity
    overflows on the sentinel block `nb`: a draw of whole capacity tiles
    from the generator, then iid_blocks_from_draw."""
    G, _ = cell_tile_geom(nb)
    n_tiles = cdiv(max(n_real, 1), G)
    raw = torch.randint(0, nb, (n_tiles * G,), generator=gen,
                        device=gen.device)
    return iid_blocks_from_draw(raw, n_real, L, nb)


def iid_blocks_from_draw(raw: torch.Tensor, n_real: int, L: int,
                         nb: int) -> torch.Tensor:
    """The capacity rule on a raw draw of whole tiles (n_tiles * G,): within
    each tile of G = nb * CELL_TILE_M consecutive cells at most `cap` cells
    of any one block take part; the rest (a >= 4-sigma tail) get the
    sentinel `nb` and keep their assignment for the round. Padded to L and
    sentinel from n_real on."""
    G, cap = cell_tile_geom(nb)
    raw = raw.to(torch.int64)
    n_tiles = raw.shape[0] // G
    tiles = raw.reshape(n_tiles, G)
    occ = tiles[:, :, None] == torch.arange(nb, device=raw.device)
    ranks = torch.cumsum(occ.to(torch.int64), dim=1) - 1      # (T, G, nb)
    rank = torch.gather(ranks, 2, tiles[:, :, None]).reshape(-1)
    blocks = torch.where(rank < cap, raw, torch.full_like(raw, nb))
    if blocks.shape[0] < L:
        blocks = torch.cat([blocks, blocks.new_full((L - blocks.shape[0],),
                                                    nb)])
    blocks = blocks[:L]
    ids = torch.arange(L, device=raw.device)
    return torch.where(ids < n_real, blocks, torch.full_like(blocks, nb))


def cell_partition_len(cfg: EngineConfig) -> int:
    """Length of the per-cell assignment table: every (padded) cell id."""
    return max(round_up(cfg.N, cfg.n_blocks), cfg.n_devices * cfg.N_local)


def cell_slot_table(blocks: torch.Tensor, cfg: EngineConfig,
                    shard: int = 0) -> torch.Tensor:
    """(nb, cell_block_width) local cell ids of shard `shard` per block,
    ascending, from the (L,) per-cell assignment of the padded layout;
    unfilled slots hold the sentinel N_local."""
    lo = shard * cfg.N_local
    return group_by_block(blocks[lo: lo + cfg.N_local], cfg.n_blocks,
                          cfg.cell_block_width, fill=cfg.N_local)


def block_ranks(blocks: torch.Tensor, nb: int, sentinel: int) -> torch.Tensor:
    """(L,) rank of each item within its block (0-based, ascending by id);
    sentinel-block items get `sentinel`."""
    occ = blocks[:, None] == torch.arange(nb, device=blocks.device)[None, :]
    ranks_all = torch.cumsum(occ.to(torch.int64), dim=0) - 1
    r = torch.gather(ranks_all, 1, blocks.clamp(0, nb - 1)[:, None])[:, 0]
    return torch.where(blocks < nb, r, torch.full_like(r, sentinel))


def global_slot_table(blocks, ranks, geom: PartitionGeometry) -> torch.Tensor:
    """(nb, J_fix) chunk id per (block, rank); every slot is filled."""
    g = torch.arange(geom.NC_fixed, device=blocks.device)
    tbl = torch.zeros((geom.nb, geom.J_fix), dtype=torch.int64,
                      device=blocks.device)
    tbl[blocks[: geom.NC_fixed], ranks[: geom.NC_fixed]] = g
    return tbl


def _selected(x, keep):
    """x[keep] for a boolean keep: its length is read back from the card,
    a host wait of its own (sync::tables)."""
    with span("sync::tables"):
        return x[keep]


def group_by_block(my_blocks, nb: int, width: int, fill: int,
                   extra=None, extra_fill: int = 0):
    """Group item ids by block: (n,) block ids (sentinel == nb) -> (nb, width)
    ids ascending within each block; unfilled slots hold `fill`. If `extra`
    is given, the matching per-item values are grouped alongside
    (unfilled -> `extra_fill`)."""
    dev = my_blocks.device
    n = my_blocks.shape[0]
    order = torch.argsort(my_blocks, stable=True)
    sb = my_blocks[order]
    with span("sync::tables"):      # on a card it reads its min and max
        cnt = torch.bincount(my_blocks, minlength=nb + 1)
    offs = torch.cumsum(cnt, dim=0) - cnt
    pos = torch.arange(n, device=dev) - offs[sb]
    keep = (sb < nb) & (pos < width)
    slots = torch.full((nb, width), fill, dtype=torch.int64, device=dev)
    slots[_selected(sb, keep), _selected(pos, keep)] = _selected(order, keep)
    if extra is None:
        return slots
    ex = torch.full((nb, width), extra_fill, dtype=torch.int64, device=dev)
    ex[_selected(sb, keep), _selected(pos, keep)] = _selected(extra[order],
                                                              keep)
    return slots, ex


def shard_slot_tables(blocks, ranks, geom: PartitionGeometry, shard: int):
    """(slots, granks) of one shard from the global (L,) assignment and
    ranks (JAX package ops/partition.py:165-180):
      slots  (nb, J_shard) the shard's local chunk ids of each block,
             ascending; unfilled slots hold its dummy chunk id `nc_cap`;
      granks (nb, J_shard) the matching within-block ranks (sentinel J_fix).
    """
    lo = shard * geom.nc_cap
    return group_by_block(
        blocks[lo: lo + geom.nc_cap], geom.nb, geom.J_shard,
        fill=geom.nc_cap, extra=ranks[lo: lo + geom.nc_cap],
        extra_fill=geom.J_fix)


def single_device_tables(blocks: torch.Tensor, geom: PartitionGeometry):
    """(slots, granks, gtbl) for one device from the (L,) block assignment:
    shard 0's shard_slot_tables and gtbl (nb, J_fix), the chunk id per
    (block, rank)."""
    if geom.n_devices != 1:
        raise ValueError(f"single_device_tables on a {geom.n_devices}-shard "
                         f"geometry: use mesh_round_tables")
    ranks = block_ranks(blocks, geom.nb, geom.J_fix)
    slots, granks = shard_slot_tables(blocks, ranks, geom, 0)
    return slots, granks, global_slot_table(blocks, ranks, geom)


def removal_from_cache(cache, gtbl, geom: PartitionGeometry) -> torch.Tensor:
    """(nb, K, B+1) per-block removal stats from a per-chunk cache (rows in
    ascending chunk id; rows past the cache are zero)."""
    pad = geom.NC_fixed - cache.shape[0]
    if pad > 0:
        cache = torch.cat([cache, cache.new_zeros((pad,) + cache.shape[1:])])
    return torch.sum(cache[: geom.NC_fixed][gtbl], dim=1)


def round_tables(blocks, cache, geom: PartitionGeometry):
    """What one fused E-step round on one device derives from its block
    assignment and the previous cache: (slots (nb, J_shard) int32, removal
    (nb, K, B+1)). The k-means round and every replay of it share this, so
    a replay sees the round's partition and O/E evolution exactly."""
    slots, _, gtbl = single_device_tables(blocks, geom)
    removal = removal_from_cache(cache[: geom.nc_cap], gtbl, geom)
    return slots.to(torch.int32).contiguous(), removal.contiguous()


class MeshTables(NamedTuple):
    """round_tables on a mesh: per shard of this process its slots (int32)
    on the shard's device, per shard of the whole mesh (every process's)
    its within-block ranks on the lead device (the re-add reads every
    shard's rows), the replicated removal stats on the lead device, and
    the re-adds' `rank_table` of the ranks on the lead device (None on one
    device)."""
    slots: list
    granks: list
    removal: torch.Tensor
    src: Optional[torch.Tensor] = None


def rank_table(granks, J_fix: int, jmax: int, device) -> torch.Tensor:
    """The rank table of a pass's re-adds, (nb, J_fix + 1) int32 on
    `device`: entry [b, r] codes the row that holds rank r of block b,
    s * jmax + j for slot j of shard s (granks[s] (nb, J_s), J_s <= jmax,
    the ranks of shard s's slots; J_fix: no rank), or -1 where no shard
    holds rank r (a zero row). Column J_fix takes every slot without a
    rank: scratch, never read. The mesh pass's per-block prologue and its
    re-add kernel read it (ops/cuda/fused_estep.py)."""
    nb = granks[0].shape[0]
    src = torch.full((nb, J_fix + 1), -1, dtype=torch.int32, device=device)
    for s, g in enumerate(granks):
        code = (s * jmax + torch.arange(g.shape[1], dtype=torch.int32,
                                        device=device))
        src.scatter_(1, g.to(device, torch.int64).clamp_(0, J_fix),
                     code.expand(nb, -1).contiguous())
    return src


def mesh_round_tables(blocks, caches, geom: PartitionGeometry,
                      devices) -> MeshTables:
    """round_tables for every shard of a mesh (JAX package
    ops/partition.py:209-226): the slot tables cut from the global
    assignment, the removal stats from the caches gathered into the global
    frame. On one device, round_tables' values. devices: this process's
    shards' devices, `caches` their caches."""
    if geom.n_devices == 1:
        slots, removal = round_tables(blocks, caches[0], geom)
        return MeshTables([slots], [None], removal)
    ranks = block_ranks(blocks, geom.nb, geom.J_fix)
    gtbl = global_slot_table(blocks, ranks, geom)
    removal = removal_from_cache(frame_rows(caches, geom), gtbl, geom)
    mine = local_shards(geom.n_devices)
    slots, granks = [], []
    for s in range(geom.n_devices):
        sl, gr = shard_slot_tables(blocks, ranks, geom, s)
        granks.append(gr)
        if s in mine:
            dev = devices[s - mine[0]]
            slots.append(sl.to(device=dev, dtype=torch.int32).contiguous())
    return MeshTables(slots, granks, removal.contiguous(), rank_table(
        granks, geom.J_fix, geom.J_shard, removal.device))


def frame_rows(vals, geom: PartitionGeometry) -> torch.Tensor:
    """The per-chunk rows of every real chunk in global chunk order, on the
    lead device: vals is one device's (nc_cap + 1, ...) buffer, or the list
    of this process's shards'. On a mesh the rows are copied into one
    (NC_real, ...) tensor: no arithmetic, and the one-device shape; across
    processes every rank's rows are all-gathered (a collective every rank
    calls)."""
    if not isinstance(vals, (list, tuple)):
        return vals[: geom.nc_cap]
    if geom.n_devices == 1:
        return vals[0][: geom.nc_cap]
    lead = vals[0].device
    rows = torch.cat([v[: geom.nc_cap].to(lead) for v in vals])
    if spans_processes(geom.n_devices):
        rows = all_gather_rows(rows)
    return rows[: geom.NC_real]


def frame_sum(vals, geom: PartitionGeometry) -> torch.Tensor:
    """Sum over the chunk axis of frame_rows(vals): one `torch.sum` over
    the (NC_real, ...) frame, the one-device shape whatever the mesh, on
    the lead device. Deterministic on the CPU and on CUDA (no atomics), so
    the same rows give the same bits on every mesh and every rank."""
    return torch.sum(frame_rows(vals, geom), dim=0)
