"""Data pipeline: deterministic synthetic LM streams + byte tokenizer text,
shardable across hosts, with checkpointable iterator state.

The port's copy of ``repro.training.data`` (numpy only): for the same
seed, step, host index and ``n_codebooks`` its batches are the
reference's byte for byte, so a run of the port and a run of the
reference read the same tokens.

The synthetic stream generates structured (learnable) sequences — a noisy
k-gram language — so training-loss-decreases tests are meaningful, unlike
uniform random tokens. Iterator state is just (seed, step); restoring it
reproduces the exact stream, which the fault-tolerance tests rely on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def as_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d) -> "DataState":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticLM:
    """Markov-ish synthetic LM data: next token = f(prev token) + noise.

    Deterministic per (seed, step, host_shard); batches are host-sharded by
    slicing the global batch, matching the (pod, data) mesh data layout.
    """

    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, n_codebooks: int = 0,
                 host_index: int = 0, host_count: int = 1):
        assert global_batch % host_count == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.host_index = host_index
        self.n_codebooks = n_codebooks
        self.state = DataState(seed=seed, step=0)
        # fixed random permutation = the "grammar"
        rng = np.random.default_rng(seed + 7777)
        self.transition = rng.permutation(vocab)

    def _gen(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        lead = (batch, self.n_codebooks) if self.n_codebooks else (batch,)
        toks = np.empty(lead + (self.seq_len,), np.int32)
        cur = rng.integers(0, self.vocab, lead)
        for t in range(self.seq_len):
            noise = rng.random(lead) < 0.1
            nxt = np.where(noise, rng.integers(0, self.vocab, lead),
                           self.transition[cur])
            toks[..., t] = nxt
            cur = nxt
        return toks

    def next_batch(self) -> Dict[str, np.ndarray]:
        """Returns {"tokens": [local_B, (ncb,) S], "targets": same} — targets
        are tokens shifted by one (next-token prediction)."""
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + self.state.step) * 65_537
            + self.host_index)
        toks = self._gen(rng, self.local_batch)
        self.state.step += 1
        return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}

    # -- checkpointable iterator state --------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return self.state.as_dict()

    def load_state_dict(self, d) -> None:
        self.state = DataState.from_dict(d)


def batch_slice(batch: Dict[str, np.ndarray], index: int,
                count: int) -> Dict[str, np.ndarray]:
    """Rows ``[index * B / count, (index + 1) * B / count)`` of every
    array of a global batch: a data rank's share, as the reference's
    ``batch_sharding`` lays the batch over the data axis."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % count:
            raise ValueError(f"batch {v.shape[0]} does not split over "
                             f"{count} data ranks")
        n = v.shape[0] // count
        out[k] = v[index * n:(index + 1) * n]
    return out


class ByteTokenizer:
    """Trivial byte-level tokenizer for the text examples (vocab 256+2)."""

    PAD, BOS = 256, 257
    vocab = 258

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        ids = [i for i in np.asarray(ids).tolist() if i < 256]
        return bytes(ids).decode("utf-8", errors="replace")


class TextFileStream:
    """Chunked next-token batches from a text corpus (byte-level)."""

    def __init__(self, text: str, seq_len: int, batch: int, *, seed: int = 0):
        self.tok = ByteTokenizer()
        self.ids = self.tok.encode(text)
        self.seq_len = seq_len
        self.batch = batch
        self.state = DataState(seed=seed, step=0)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.state.seed * 99991 + self.state.step)
        n = len(self.ids) - self.seq_len - 1
        starts = rng.integers(0, max(n, 1), self.batch)
        toks = np.stack([self.ids[s:s + self.seq_len + 1] for s in starts])
        self.state.step += 1
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def state_dict(self):
        return self.state.as_dict()

    def load_state_dict(self, d):
        self.state = DataState.from_dict(d)
