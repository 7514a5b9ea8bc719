"""Data: the Zipfian bigram language of the Galen LM testbed, the
Gaussian-blob images of the ResNet testbed (a CIFAR stand-in), and the
production token pipeline (``DataConfig``, ``ShardedTokenDataset``,
``Prefetcher``).

The generators draw from ``np.random.default_rng`` exactly as the JAX
package's ``data/pipeline.py`` does, so the same seed gives the same
tokens and pixels bit for bit, and ``ShardedTokenDataset.batch_at`` the
same batch for the same (step, host). Tensors go to the device only at
the boundary (``bigram_lm``, ``blob_images``, ``Prefetcher``).
"""
from __future__ import annotations

import glob
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


def make_bigram_table(vocab: int, seed: int = 0,
                      branching: int = 4) -> np.ndarray:
    """Each token has `branching` likely successors — learnable structure."""
    rng = np.random.default_rng(seed)
    table = np.zeros((vocab, vocab), np.float64)
    for v in range(vocab):
        succ = rng.choice(vocab, size=branching, replace=False)
        probs = rng.dirichlet(np.ones(branching) * 0.5) * 0.9
        table[v, succ] = probs
        table[v] += 0.1 / vocab
        table[v] /= table[v].sum()
    return table


def sample_bigram(table: np.ndarray, batch: int, seq: int,
                  seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vocab = table.shape[0]
    out = np.zeros((batch, seq), np.int32)
    out[:, 0] = rng.integers(0, vocab, batch)
    cdf = np.cumsum(table, axis=1)
    for t in range(1, seq):
        u = rng.random(batch)
        out[:, t] = np.argmax(cdf[out[:, t - 1]] > u[:, None], axis=1)
    return out


def bigram_lm(vocab: int, batch: int, seq: int, seed: int = 0,
              device="cuda") -> dict:
    table = make_bigram_table(vocab, seed)
    toks = sample_bigram(table, batch, seq, seed + 1)
    return {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=device)}


def make_blob_protos(num_classes: int, img: int, channels: int = 3,
                     proto_seed: int = 1234) -> np.ndarray:
    """Fixed class prototypes (the 'dataset'); batches only vary noise."""
    rng = np.random.default_rng(proto_seed)
    protos = rng.normal(0, 1, (num_classes, img, img, channels))
    # low-pass so classes differ in coarse structure
    for _ in range(2):
        protos = (protos + np.roll(protos, 1, 1) + np.roll(protos, 1, 2)) / 3
    return protos / protos.std()


def blob_images(num_classes: int, batch: int, img: int, seed: int = 0,
                channels: int = 3, noise: float = 1.3,
                proto_seed: int = 1234, device="cuda") -> dict:
    """``{"images": f32 [batch, img, img, channels] (NHWC), "labels":
    int64 [batch]}``: each image its class prototype plus Gaussian
    noise."""
    protos = make_blob_protos(num_classes, img, channels, proto_seed)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, batch)
    x = protos[labels] + rng.normal(0, noise, (batch, img, img, channels))
    return {"images": torch.as_tensor(x.astype(np.float32), device=device),
            "labels": torch.as_tensor(labels, dtype=torch.int64,
                                      device=device)}


# ---------------------------------------------------------------------------
# Production pipeline: sharded token shards + prefetch
# ---------------------------------------------------------------------------

@dataclass
class DataConfig:
    seq_len: int = 4096
    global_batch: int = 256
    shuffle_seed: int = 0
    prefetch: int = 2


class ShardedTokenDataset:
    """Deterministic per-host view over token shards.

    ``path`` may be a directory of ``*.npy`` uint16/uint32 token shards or
    ``synthetic://vocab`` to generate bigram data on the fly (offline mode).
    Restart safety: batches are a pure function of (seed, step) — resuming
    at step k reproduces the exact stream without replaying k batches.
    Batches are numpy (``{"tokens": int32 [host_batch, seq_len]}``);
    ``Prefetcher`` moves them to the device.
    """

    def __init__(self, path: str, cfg: DataConfig, host_id: int = 0,
                 num_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.host_batch = cfg.global_batch // num_hosts
        if path.startswith("synthetic://"):
            vocab = int(path.split("://")[1])
            self.table = make_bigram_table(vocab, cfg.shuffle_seed)
            self.tokens = None
        else:
            files = sorted(glob.glob(os.path.join(path, "*.npy")))
            if not files:
                raise FileNotFoundError(f"no token shards under {path}")
            self.tokens = np.concatenate(
                [np.load(f, mmap_mode="r") for f in files])
            self.table = None

    def batch_at(self, step: int) -> dict:
        seed = (self.cfg.shuffle_seed * 1_000_003 + step) * self.num_hosts \
            + self.host_id
        if self.table is not None:
            toks = sample_bigram(self.table, self.host_batch,
                                 self.cfg.seq_len, seed)
        else:
            rng = np.random.default_rng(seed)
            n = len(self.tokens) - self.cfg.seq_len - 1
            starts = rng.integers(0, n, self.host_batch)
            toks = np.stack([self.tokens[s:s + self.cfg.seq_len]
                             for s in starts]).astype(np.int32)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(item: dict, device) -> dict:
    """A numpy batch -> int64 tensors on ``device`` (the index dtype of
    the port's embedding and ``lm_loss``). A CUDA copy goes from pinned
    memory without a wait, on the current stream, so kernels queued later
    on that stream see the batch; ``torch.tensor(x, device="cuda")``
    would wait for the stream instead."""
    dev = torch.device(device)
    out = {}
    for k, v in item.items():
        t = torch.from_numpy(np.asarray(v, np.int64))
        out[k] = t if dev.type == "cpu" else \
            t.pin_memory().to(dev, non_blocking=True)
    return out


class Prefetcher:
    """Background-thread host->device prefetch (keeps the card fed):
    up to ``depth`` batches already on ``device`` (``to_device``). When
    ``it`` ends, iteration ends; an error on the thread is raised by
    ``__next__``."""

    _END = object()

    def __init__(self, it: Iterator[dict], depth: int = 2, device="cuda"):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.device = device
        self._stop = threading.Event()

        def work():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self.q.put(to_device(item, self.device))
            except Exception as e:      # handed to the consumer
                self.q.put(e)
                return
            self.q.put(self._END)

        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._END:
            self.q.put(item)
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
