"""Elastic scaling: resume a checkpoint onto a different mesh.

The port of ``repro.runtime.elastic``.  The checkpoint format is
mesh-agnostic (the full logical array of every leaf, in the reference's
stacked layout), so growing or shrinking the mesh between runs is a
restart on another mesh: every rank reads the whole checkpoint and keeps
its block of each leaf under the target mesh's specs.  The ECI tie-in:
after a reshard every new replica's parameter cache starts Invalid and
faults its lines in, a remote agent joining with an empty cache.
"""
from __future__ import annotations

from .. import convert
from ..checkpoint import checkpoint as ckpt
from ..launch import sharding as sh
from ..launch.mesh import mesh_device


def resume_on_mesh(path: str, state_like, mesh, cfg, mode: str = "2d"):
    """(the ``TrainState`` of the checkpoint at ``path`` on ``mesh``, its
    meta).  ``state_like`` is a port ``TrainState`` of the model ``cfg``
    (per layer, DTensors or not; only its shapes are read) and the
    checkpoint any run's,
    in the reference's layout: the params and both moments come out as
    DTensors under ``param_specs(params, mode)``, ``step`` and
    ``data_step`` replicated.  Every rank reads the file; there is no
    communication."""
    stacked, meta = ckpt.load(path, convert.stack_train_state(
        sh.stand_ins(state_like), cfg), device=mesh_device(mesh))
    st = convert.unstack_train_state(stacked, cfg)
    specs = sh.param_specs(st.params, mode)

    def put(tree):
        return sh.distribute_tree(mesh, tree, specs)

    def rep(t):
        return sh.distribute(t, mesh, sh.P())

    opt = type(st.opt)(step=rep(st.opt.step), m=put(st.opt.m),
                       v=put(st.opt.v))
    return type(st)(params=put(st.params), opt=opt,
                    data_step=rep(st.data_step)), meta


def world_descriptor(mesh) -> dict:
    return {"axes": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "n_devices": int(mesh.size())}
