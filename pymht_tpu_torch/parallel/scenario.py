"""Scenario batching on one device (counterpart of the single-device half
of pymht_tpu/parallel/scenario.py: ``make_batched_step``,
``batch_states``).

B independent scenarios advance one scan together.  Where the JAX
package ``jax.vmap``s ``scan_step``, the port writes the scenario axis
out: every tensor of the state, the initiator state, the scan, the AIS
batch and the step's outputs carries a leading B, and every core function
takes it (``batch.lead_index``), with any selection method, with or
without the AIS branch and with or without the spatial pre-gate.  The
loops and branches that the port reads on the host keep vmap's semantics
(``sync.while_loop``, ``sync.cond`` and the batched loops of
``ops/lp.py``): a loop runs while any scenario's test holds, a scenario
that is done keeps its carry, and a branch runs where some scenario takes
it and is selected per scenario.  A batched scan therefore makes a
number of launches that does not grow with B, K1 among them once, and
about as many host reads as the slowest of its scenarios alone.
"""
from __future__ import annotations

from ..core import initiator as initiator_mod
from ..core.config import TrackerParams, TrackerShapes
from ..core.state import empty_state
from ..core.tracker import _resolve_device, scan_step


def make_batched_step(shapes: TrackerShapes, params: TrackerParams,
                      method: str = 'lagrangian', use_ais: bool = False):
    """``scan_step`` over a leading scenario axis: returns
    ``step(state_b, istate_b, scan_b, ais_b=None) -> (state_b, istate_b,
    outputs_b)``.  ``ais_b`` is the scenarios' ``AisBatch`` ``[B, A,
    ...]`` (read only with ``use_ais``).  An unknown ``method`` raises the
    dispatcher's ValueError at the first step, as the JAX step does when
    traced."""

    def step(state_b, istate_b, scan_b, ais_b=None):
        return scan_step(state_b, istate_b, scan_b, ais_b, shapes, params,
                         method=method, use_ais=use_ais)

    return step


def batch_states(shapes: TrackerShapes, params: TrackerParams, n: int,
                 device=None):
    """(state, initiator state) of ``n`` empty scenarios, on ``device``:
    the GPU unless the caller names another (``device='cpu'`` runs the
    kernels' plain twins); with no CUDA device ``None`` raises."""
    dev = _resolve_device(device, "batch_states")
    return (empty_state(shapes, params, dev, batch=(n,)),
            initiator_mod.empty_initiator(shapes, dev, batch=(n,)))
