"""Assigned-architecture configs (and the paper's RNN-T).

Every module defines an ``ARCH`` ArchSpec with the assigned
hyper-parameters (its citation in the docstring), a reduced smoke config
and its sharding rules as data. ``get_arch(id)`` resolves ``--arch <id>``.
"""

from repro_torch.configs.registry import get_arch, list_archs

__all__ = ["get_arch", "list_archs"]
