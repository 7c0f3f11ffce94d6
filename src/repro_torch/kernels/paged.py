"""The block pool's contract that both paged decode kernels
(`paged_decode_attention`, `paged_mla_decode`) read, the pool gather of
their plain versions, and the split of S that every decode kernel plans.
A pool is (n_blocks, block_size, ...) (`models/model.py:
init_paged_cache`); slot i's position p is row p % block_size of block
block_tables[i, p // block_size].
"""
from __future__ import annotations

import functools
import math

import torch

PAGED_ROWS = 8                   # a pool block's rows: a multiple of this


def paged_view(pool, block_tables):
    """Gather each slot's logical strip from the pool:
    (n_blocks, bs, ...) + (b, max_blocks) -> (b, max_blocks * bs, ...)."""
    v = pool[block_tables.long()]
    return v.reshape((v.shape[0], v.shape[1] * v.shape[2]) + v.shape[3:])


def check_tables(block_tables, lengths, b: int) -> None:
    """block_tables (b, max_blocks) and lengths (b,), both integers, on
    every device.  Raises ValueError / TypeError."""
    if block_tables.ndim != 2 or block_tables.shape[0] != b or (
            tuple(lengths.shape) != (b,)):
        raise ValueError(f"want block_tables (b, max_blocks) and lengths "
                         f"(b,) for b={b}; got {tuple(block_tables.shape)}, "
                         f"{tuple(lengths.shape)}")
    if block_tables.is_floating_point() or lengths.is_floating_point() or (
            block_tables.dtype == torch.bool):
        raise TypeError(f"block_tables and lengths must be integers; got "
                        f"{block_tables.dtype}, {lengths.dtype}")


def card_tables(block_tables, lengths):
    """The tables as int32 rows of unit stride and the lengths as
    contiguous int64, as the kernels read them (a copy only where the
    caller's differ)."""
    tables = block_tables.to(torch.int32)
    if tables.stride(1) != 1:
        tables = tables.contiguous()
    return tables, lengths.to(torch.int64).contiguous()


def check_pools(*pools) -> None:
    """The CUDA kernels' contract on their pools: blocks of a multiple of
    PAGED_ROWS rows, one set of strides shared by every pool, each a
    multiple of 8 elements with the last dim contiguous, and 16-byte
    aligned bases.  Raises ValueError."""
    bs, strides = pools[0].shape[1], pools[0].stride()
    if bs % PAGED_ROWS:
        raise ValueError(f"block_size {bs} is not a multiple of "
                         f"{PAGED_ROWS}")
    if strides[-1] != 1 or any(st % 8 for st in strides[:-1]) or any(
            p.stride() != strides or p.data_ptr() % 16 for p in pools):
        raise ValueError(f"the pools must share strides, each a multiple of "
                         f"8 elements with the last dim contiguous, and be "
                         f"16-byte aligned; got "
                         f"{[p.stride() for p in pools]}")


@functools.lru_cache(maxsize=1024)
def split_plan(n_blocks: int, S: int, n_sms: int,
               tile: int) -> tuple[int, int]:
    """(n_splits, split_len): S cut into `tile`-aligned pieces, as many as
    the n_blocks blocks of one piece can take while every block of the
    call still fits one wave of one block per SM (at least one piece, at
    most one per tile).  Pure: the same arguments give the same plan."""
    want = max(1, min(math.ceil(S / tile), n_sms // n_blocks))
    split_len = tile * math.ceil(math.ceil(S / want) / tile)
    return math.ceil(S / split_len), split_len
