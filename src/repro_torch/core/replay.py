"""Device-resident replay ring for the DDPG agent (paper: 2000 transitions).

Transitions are written at ``(ptr + i) % capacity`` and sampled uniformly
over the filled prefix, as the JAX package's ``DeviceReplay``. The ring
is a ``DeviceReplayData``: five tensors on the device and ``ptr`` /
``size`` as 0-d int64 tensors beside them, so a ring write
(``device_replay_push``) reads and advances its position on the device
and can run inside a captured CUDA graph. It writes in place: the
ring's tensors are never reallocated, so a graph that reads them stays
valid. ``ptr``/``size`` are mirrored on the host (``DeviceReplay.ptr`` /
``.size``) so the ``size >= batch_size`` update gate and the bound of a
sample's indices never synchronize the device; an engine that pushes
inside a graph advances the mirrors from its static schedule
(``DeviceReplay.adopt``). A population keeps its members' rings as one
stack of (P, capacity, ·) tensors (``ddpg.stack_states``), each member's
``DeviceReplay`` rebound to views of its slice (``DeviceReplay.rebind``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class DeviceReplayData(NamedTuple):
    """The ring's tensors, what the pure ring functions read and write."""
    states: torch.Tensor        # (capacity, state_dim) f32
    actions: torch.Tensor       # (capacity, action_dim) f32
    rewards: torch.Tensor       # (capacity,) f32
    next_states: torch.Tensor   # (capacity, state_dim) f32
    dones: torch.Tensor         # (capacity,) f32
    ptr: torch.Tensor           # () int64: the next write slot
    size: torch.Tensor          # () int64: the filled prefix


def device_replay_init(capacity: int, state_dim: int, action_dim: int,
                       device="cpu") -> DeviceReplayData:
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    return DeviceReplayData(
        states=torch.zeros((capacity, state_dim), **f32),
        actions=torch.zeros((capacity, action_dim), **f32),
        rewards=torch.zeros((capacity,), **f32),
        next_states=torch.zeros((capacity, state_dim), **f32),
        dones=torch.zeros((capacity,), **f32),
        ptr=torch.zeros((), **i64), size=torch.zeros((), **i64))


def device_replay_push(data: DeviceReplayData, s, a, r, s2,
                       d) -> DeviceReplayData:
    """Ring write of n transitions (n from the operands' shapes), in
    place, the position read and advanced on the device. Oversized
    batches keep only the last ``capacity`` rows, landing where
    sequential pushes would have left them (the JAX package's
    ``device_replay_push``). Returns ``data``."""
    capacity = data.states.shape[0]
    n = s.shape[0]
    if n == 0:
        return data
    if n >= capacity:
        s, a, r, s2, d = (x[n - capacity:] for x in (s, a, r, s2, d))
    m = s.shape[0]
    # slot of the first surviving row under sequential-push semantics
    start = (data.ptr + (n - m)) % capacity
    idx = (start + torch.arange(m, device=data.ptr.device)) % capacity
    for buf, col in zip(data[:5], (s, a, r, s2, d)):
        buf.index_copy_(0, idx, col.to(buf.dtype))
    data.ptr.copy_((data.ptr + n) % capacity)
    data.size.copy_(torch.clamp_max(data.size + n, capacity))
    return data


def device_replay_sample(data: DeviceReplayData, idx: torch.Tensor):
    """The transitions at ``idx``: (s, a, r, s2, done). The indices are
    drawn outside (``sample_indices``; the parity tests feed the JAX
    package's)."""
    return (data.states[idx], data.actions[idx], data.rewards[idx],
            data.next_states[idx], data.dones[idx])


def sample_indices(shape, size: int, gen: torch.Generator,
                   device) -> torch.Tensor:
    """Uniform indices over a filled prefix of ``size`` (a host int: the
    mirror, or the size a static schedule gives), drawn on the device;
    ``shape`` an int or a tuple."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.randint(0, max(int(size), 1), shape, generator=gen,
                         device=device)


class DeviceReplay:
    """Host shim over ``DeviceReplayData`` with the ``ReplayBuffer`` API;
    the ring's tensors are also its attributes (``states`` ...)."""

    def __init__(self, capacity: int, state_dim: int, action_dim: int,
                 device="cuda"):
        self.capacity = capacity
        self.device = torch.device(device)
        self.rebind(device_replay_init(capacity, state_dim, action_dim,
                                       self.device))
        self.ptr = 0
        self.size = 0

    def rebind(self, data: DeviceReplayData):
        """Take ``data`` (the same shapes, the same contents: views of a
        population's stacked ring) as the ring's tensors."""
        self.data = data
        (self.states, self.actions, self.rewards, self.next_states,
         self.dones) = data[:5]

    def load(self, data: DeviceReplayData, ptr: int, size: int):
        """Take a restored ring (checkpoint resume): its tensors copied
        into the ring's own (never rebound: a graph that reads them, or a
        population's stack they are views of, stays valid), the host
        mirrors from the checkpoint's manifest, so the sampleable prefix
        and the next write slot both resume."""
        for dst, src in zip(self.data, data):
            dst.copy_(src)
        self.ptr = int(ptr) % self.capacity
        self.size = min(int(size), self.capacity)

    def push_batch(self, s, a, r, s_next, done):
        """Bulk insert N transitions (numpy or tensors) in one ring
        write; the host mirrors advance without reading the device."""
        n = len(s)
        if n == 0:
            return
        cols = [torch.as_tensor(np.asarray(x, np.float32)
                                if not isinstance(x, torch.Tensor) else x,
                                device=self.device)
                for x in (s, a, r, s_next, done)]
        device_replay_push(self.data, *cols)
        self.adopt(n)

    def adopt(self, pushed: int):
        """Advance the host mirrors after ``pushed`` transitions were
        written on the device (by ``push_batch``, or inside a graph)."""
        self.ptr = int((self.ptr + pushed) % self.capacity)
        self.size = int(min(self.size + pushed, self.capacity))

    def sample_indices(self, shape, gen: torch.Generator) -> torch.Tensor:
        """Uniform indices over the filled prefix, drawn on the device."""
        return sample_indices(shape, self.size, gen, self.device)

    def gather(self, idx: torch.Tensor):
        """The transitions at ``idx``: (s, a, r, s2, done)."""
        return device_replay_sample(self.data, idx)

    def sample(self, batch: int, gen: Optional[torch.Generator] = None,
               idx: Optional[torch.Tensor] = None):
        """Uniform sample of ``batch`` transitions drawn from ``gen``, or
        the transitions at ``idx`` when given."""
        if idx is None:
            idx = self.sample_indices((batch,), gen)
        return self.gather(idx)

    def __len__(self):
        return self.size
