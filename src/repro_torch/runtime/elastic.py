"""Elastic scaling: restore a checkpoint onto a different mesh (the PyTorch port).

Checkpoints are mesh-agnostic (full logical arrays, checkpoint/manager.py),
and shardings are *derived* from logical axis rules per mesh — so scaling
from 1 pod to 2 (or 16x16 to 8x32, or recovering with a dead slice cordoned
off) is: build the new mesh, recompute shardings, restore.  Batch math
(per-pod microbatching) rescales so the global batch — and therefore the
training trajectory — is preserved.  The GPULZ blobs themselves are
mesh-agnostic too: when the manager's batched dispatch is shard-mapped
(``lz_mesh``), ``restore_onto_mesh`` re-points decode sharding at the
restore-side mesh, so a checkpoint compressed on an 8-device mesh restores
on a 2-device one.

The port's meshes are ``launch/mesh.Mesh`` (the reference's axis names and
sizes over torch devices) or plain device sequences; the codec's batch
axis is the flat device sequence's ``"data"``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch import steps as steps_lib


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_axes: dict
    new_axes: dict
    microbatch_scale: float  # multiply TrainConfig.microbatches by this

    def describe(self) -> str:
        return (
            f"remesh {self.old_axes} -> {self.new_axes}; "
            f"microbatches x{self.microbatch_scale:g}"
        )


def plan_remesh(old_mesh, new_mesh) -> ElasticPlan:
    oa = dict(zip(old_mesh.axis_names, old_mesh.devices.shape))
    na = dict(zip(new_mesh.axis_names, new_mesh.devices.shape))
    old_dp = oa.get("pod", 1) * oa.get("data", 1)
    new_dp = na.get("pod", 1) * na.get("data", 1)
    # fewer data-parallel ranks => more microbatches to hold global batch
    return ElasticPlan(oa, na, microbatch_scale=old_dp / max(1, new_dp))


def restore_onto_mesh(manager, cfg, traincfg, new_mesh, template=None):
    """Restore the latest checkpoint with shardings for ``new_mesh``.

    When the manager's batched compression dispatch is shard-mapped
    (``lz_mesh`` set, or the ``"sharded"`` decoder selected), the decode
    shards must track the mesh we are restoring ONTO — not the (possibly
    larger, possibly gone) mesh the checkpoint was written on.  Blobs are
    mesh-agnostic bytes, so a step compressed on an 8-device mesh restores
    on 2 devices by simply re-pointing ``lz_mesh`` here.
    """
    if template is None:
        template = steps_lib.abstract_train_state(cfg, traincfg)
    shardings = steps_lib.train_state_shardings(cfg, traincfg, new_mesh)
    if (
        getattr(manager, "lz_mesh", None) is not None
        or getattr(manager, "lz_decoder", None) == "sharded"
    ):
        # lz_batch_axis must track the mesh swap: the axis the checkpoint
        # was written with may not exist on the restore-side mesh (e.g. a
        # ("pod", "data") save restoring onto a ("data",) mesh).  Keep an
        # explicitly configured axis when the new mesh still has it; only
        # when it is gone fall back to None so normalize_batch_axes
        # re-derives the batch axes from the restore-side mesh.
        axis = getattr(manager, "lz_batch_axis", None)
        if axis is not None:
            from repro_torch.sharding.batch import normalize_batch_axes

            try:
                normalize_batch_axes(new_mesh, axis)
            except ValueError:
                axis = None
        manager = dataclasses.replace(
            manager, lz_mesh=new_mesh, lz_batch_axis=axis
        )
    state, step = manager.restore_latest(template, shardings)
    return state, step
