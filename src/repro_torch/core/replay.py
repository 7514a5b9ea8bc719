"""Device-resident replay ring for the DDPG agent (paper: 2000 transitions).

Transitions are written at ``(ptr + i) % capacity`` and sampled uniformly
over the filled prefix, as the JAX package's ``DeviceReplay``. The ring is
a set of tensors on the device; ``ptr``/``size`` are mirrored on the host
so the ``size >= batch_size`` update gate never synchronizes the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class DeviceReplay:
    def __init__(self, capacity: int, state_dim: int, action_dim: int,
                 device="cuda"):
        self.capacity = capacity
        self.device = torch.device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.states = torch.zeros((capacity, state_dim), **f32)
        self.actions = torch.zeros((capacity, action_dim), **f32)
        self.rewards = torch.zeros((capacity,), **f32)
        self.next_states = torch.zeros((capacity, state_dim), **f32)
        self.dones = torch.zeros((capacity,), **f32)
        self.ptr = 0
        self.size = 0

    def push_batch(self, s, a, r, s_next, done):
        """Bulk insert N transitions in one ring write. Oversized batches
        keep only the last ``capacity`` rows, where sequential pushes
        would have left them."""
        s = np.asarray(s, np.float32)
        n = s.shape[0]
        if n == 0:
            return
        cols = [s, np.asarray(a, np.float32), np.asarray(r, np.float32),
                np.asarray(s_next, np.float32), np.asarray(done, np.float32)]
        cut = max(0, n - self.capacity)
        idx = (self.ptr + cut + np.arange(n - cut)) % self.capacity
        idx_t = torch.as_tensor(idx, device=self.device)
        for buf, col in zip((self.states, self.actions, self.rewards,
                             self.next_states, self.dones), cols):
            buf[idx_t] = torch.as_tensor(col[cut:], device=self.device)
        self.ptr = int((self.ptr + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample_indices(self, batch: int,
                       gen: torch.Generator) -> torch.Tensor:
        """Uniform indices over the filled prefix, drawn on the device."""
        return torch.randint(0, max(self.size, 1), (batch,), generator=gen,
                             device=self.device)

    def gather(self, idx: torch.Tensor):
        """The transitions at ``idx``: (s, a, r, s2, done)."""
        return (self.states[idx], self.actions[idx], self.rewards[idx],
                self.next_states[idx], self.dones[idx])

    def sample(self, batch: int, gen: Optional[torch.Generator] = None,
               idx: Optional[torch.Tensor] = None):
        """Uniform sample of ``batch`` transitions drawn from ``gen``, or
        the transitions at ``idx`` when given (the parity tests feed the
        JAX package's replay indices)."""
        if idx is None:
            idx = self.sample_indices(batch, gen)
        return self.gather(idx)

    def __len__(self):
        return self.size
