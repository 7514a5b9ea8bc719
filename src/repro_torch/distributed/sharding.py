"""Member-axis placement of a population search fleet (the JAX package's
``distributed/sharding.py``, its member-axis rules only).

The JAX package places a fleet's stacked epoch carry on a device mesh
along the member axis (``NamedSharding(mesh, P("data"))``), one member
per device. The port runs a fleet on one device: ``member_sharding``
and ``population_shardings`` are the identity placement there (every
leaf stays on the device it lies on) and refuse a mesh of more than one
device rather than place anything elsewhere. ``pad_members`` is the
reference's, pure. A ``mesh`` here is any object with ``axis_names``
and a ``shape`` mapping of axis extents (the JAX ``Mesh``'s); the port
builds none yet (ROADMAP.md: a fleet over several cards). The model-
sharding rules of the reference module (its PartitionSpecs for
parameters and activations) have no counterpart.
"""
from __future__ import annotations

import math

import torch


def _one_device(mesh) -> None:
    n = 1 if mesh is None else math.prod(
        int(v) for v in dict(mesh.shape).values())
    if n != 1:
        raise ValueError(
            f"the port places a fleet on one device; a mesh of {n} devices "
            f"({dict(mesh.shape)}) waits for the multi-card fleet")


def member_sharding(mesh, ndim: int, device=None):
    """Placement of a stacked leaf of ``ndim`` dims: on one device, that
    device (``device``, the leaf's own); a mesh of several devices is
    refused."""
    _one_device(mesh)
    return None if device is None else torch.device(device)


def population_shardings(tree, mesh):
    """The placement of every leaf of a STACKED population tree (dicts,
    lists, named tuples of tensors): each leaf's own device, as
    ``member_sharding`` gives it."""
    _one_device(mesh)
    if isinstance(tree, torch.Tensor):
        return member_sharding(mesh, tree.dim(), tree.device)
    if isinstance(tree, dict):
        return {k: population_shardings(v, mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(population_shardings(v, mesh) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(population_shardings(v, mesh) for v in tree)
    return None


def pad_members(trees: list, data: int) -> list:
    """Pad a list of per-member trees up to a multiple of the mesh data
    extent by repeating the last member (its outputs are discarded), so
    the stacked member axis divides evenly across devices."""
    pad = (-len(trees)) % data
    return list(trees) + list(trees[-1:]) * pad
