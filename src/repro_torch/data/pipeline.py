"""Client data pipeline: per-client shards, deterministic epoch shuffling,
fixed-size batch iterators (padded final batch with label -1 = ignore), and
synthetic token streams for the LLM-scale configs.

A copy of ``repro.data.pipeline``: ``ClientShard.batches`` must stay
bit-identical to it, because the parity tests rely on both packages
drawing the same batch order.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import Dataset


@dataclasses.dataclass
class ClientShard:
    client_id: int
    x: np.ndarray
    y: np.ndarray

    @property
    def num_examples(self) -> int:
        return len(self.y)

    def batches(self, batch_size: int, *, epoch: int = 0, seed: int = 0,
                drop_remainder: bool = False) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        # SeedSequence entropy, not builtin hash: CPython's hash(-1) ==
        # hash(-2) collides the pooled-cluster shard (client_id=-1) with
        # other negative ids, and builtin-hash streams are fragile across
        # interpreters.  Masking keeps the entropy non-negative while
        # staying injective over 32-bit ids.  SALT_BATCH pins the stream
        # into the fed/schedule.py registry: the unsalted
        # [seed, client, epoch] shape could equal lifecycle's leave stream
        # [seed, round, SALT_LEAVE] when client == round and epoch == 0x1F.
        # Local import: repro_torch.fed's package init pulls in rounds -> data.
        from repro_torch.fed.schedule import SALT_BATCH
        rng = np.random.default_rng(np.random.SeedSequence(
            [seed & 0xFFFFFFFF, self.client_id & 0xFFFFFFFF,
             SALT_BATCH, epoch & 0xFFFFFFFF]))
        order = rng.permutation(self.num_examples)
        for start in range(0, self.num_examples, batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size:
                if drop_remainder:
                    return
                pad = batch_size - len(idx)
                x = np.concatenate([self.x[idx], np.zeros((pad,) + self.x.shape[1:],
                                                          self.x.dtype)])
                y = np.concatenate([self.y[idx], np.full(pad, -1, self.y.dtype)])
                yield x, y
                return
            yield self.x[idx], self.y[idx]


def make_client_shards(ds: Dataset, num_clients: int, alpha: float,
                       *, seed: int = 0) -> list[ClientShard]:
    """Paper setup: Dirichlet(alpha) label-skew split across clients."""
    parts = dirichlet_partition(ds.y_train, num_clients, alpha, seed=seed)
    return [ClientShard(i, ds.x_train[p], ds.y_train[p]) for i, p in enumerate(parts)]


class ClientStore:
    """Host-resident client universe over a base shard pool (DESIGN.md §15).

    Cross-device FL universes (10^5-10^7 clients) dwarf any dataset we can
    physically partition, so the store separates the CLIENT ID SPACE from
    the DATA POOL: ``universe`` virtual clients map onto ``len(base)``
    materialised shards via ``row_of[vid] = vid % n_base``.  Virtual
    clients aliasing the same base row share the shard OBJECT — and with
    it ``client_id``-seeded batch streams — so loop/sharded parity and
    resume bit-identity hold over the virtual universe too.  Per-client
    federated state (labels, speed profiles, sampled rosters) is keyed by
    VIRTUAL id everywhere; only data access dereferences ``row_of``.

    With ``universe=None`` this is the identity store: ``store[i]`` is
    ``shards[i]`` and every array round-trips unchanged, which keeps the
    non-universe configs byte-identical to the pre-store runtime.
    """

    def __init__(self, shards: list[ClientShard], *,
                 universe: int | None = None):
        if not shards:
            raise ValueError("ClientStore needs at least one base shard")
        self.base = list(shards)
        self.universe = len(self.base) if universe is None else int(universe)
        if self.universe < len(self.base):
            raise ValueError(
                f"universe={self.universe} smaller than the base shard "
                f"pool ({len(self.base)})")
        self.row_of = (np.arange(self.universe) % len(self.base)).astype(
            np.int64)
        self.base_sizes = np.asarray(
            [sh.num_examples for sh in self.base], np.int64)

    @property
    def n_base(self) -> int:
        return len(self.base)

    @property
    def sizes(self) -> np.ndarray:
        """(universe,) per-virtual-client example counts."""
        return self.base_sizes[self.row_of]

    def __len__(self) -> int:
        return self.universe

    def __getitem__(self, vid: int) -> ClientShard:
        return self.base[self.row_of[int(vid)]]

    def __iter__(self) -> Iterator[ClientShard]:
        for r in self.row_of:
            yield self.base[r]


def token_stream(vocab_size: int, batch: int, seq: int, *, seed: int = 0,
                 num_batches: int = 1) -> Iterator[dict[str, np.ndarray]]:
    """Synthetic LM batches (tokens + next-token labels) for LLM-scale runs."""
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        toks = rng.integers(0, vocab_size, size=(batch, seq + 1), dtype=np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
