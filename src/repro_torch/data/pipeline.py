"""Synthetic data: the Zipfian bigram language of the Galen LM testbed
and the Gaussian-blob images of the ResNet testbed (a CIFAR stand-in).

The generators draw from ``np.random.default_rng`` exactly as the JAX
package's ``data/pipeline.py`` does, so the same seed gives the same
tokens and pixels bit for bit. Tensors go to the device only at the
boundary (``bigram_lm``, ``blob_images``).
"""
from __future__ import annotations

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
