"""Expert parallelism: the MoE expert bank split on its E axis over ``expert``.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/parallel/ep.py``.
A MoE feed-forward keeps its experts stacked (``in.w [E, d, ff]``, ``in.b
[E, ff]``, ``out.w [E, ff, d]``, ``out.b [E, d]``); under ``expert``
shards each rank holds E/X of them and their moments
(``expert_partition_specs``), everything else replicated. The JAX package
places the bank and lets XLA insert the combine's reduce; here
``models/conformer.MoEFeedForward`` runs each rank's experts over all the
frames of its data line, sums the gated combine over ``expert`` (*g*,
``tp.reduce_from``) and sends the experts' input and gates through *f*
(``tp.copy_to``), so the replicated router and LayerNorm get their whole
gradient on every rank. The load-balance counts come from the replicated
router: they sum over ``data`` only (``mesh.batch_sum``).
"""

from __future__ import annotations

from .mesh import DATA_AXIS, EXPERT_AXIS, Mesh, make_grid


def make_mesh_dp_ep(num_data: int, num_expert: int, device=None) -> Mesh:
    """A ``(data, expert)`` mesh over the process group's ranks, ``expert`` minor."""
    return make_grid({DATA_AXIS: num_data, EXPERT_AXIS: num_expert}, device)


def _spec_for(path_keys: list, leaf) -> tuple:
    """Stacked expert weights (``in`` / ``out`` leaves of rank >= 2 under
    ``moe``) split on their leading E axis; the router and the rest replicate."""
    if "moe" in path_keys:
        parent = path_keys[-2] if len(path_keys) >= 2 else ""
        if parent in ("in", "out") and len(leaf.shape) >= 2:
            return (EXPERT_AXIS,)
    return ()


def expert_partition_specs(params: dict) -> dict:
    """``{name: spec}`` for every leaf of ``params`` (``state_dict`` keys)."""
    return {k: _spec_for(k.split("."), v) for k, v in params.items()}


def setup_expert_parallel(mesh: Mesh, params: dict, opt_state=None, batch=None):
    """Place training state for dp x ep: each rank's experts and their
    moments (``expert_partition_specs``), the rest replicated, the batch's
    rows by data index."""
    from .fsdp import place

    return place(mesh, params, opt_state, expert_partition_specs(params), batch)
