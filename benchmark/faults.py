"""Faults planted in the timed path under the harness, for the tests and
for ``control.py --fault``: each has to make ``correct`` come out false.
One card makes no exchange between chips, so that fault cannot occur."""
import numpy as np

import run


def unchanged(tracker):
    """A step that returns its state unchanged."""
    real = tracker._step

    def step(packed, **kw):
        st, ist = ({k: v.clone() for k, v in run.fields(s).items()}
                   for s in (tracker.state, tracker.init_state))
        _, _, out = real(packed, **kw)
        return (type(tracker.state)(**st), type(tracker.init_state)(**ist),
                out)
    tracker._step = step


def half_left_out(tracker):
    """Half of the scan's measurements left out of the step."""
    real = tracker._pack_inputs

    def pack(t, z, ais=()):
        return real(t, np.asarray(z)[: len(z) // 2], ais)
    tracker._pack_inputs = pack


def answer_altered(tracker):
    """One answer altered where it is produced: a track's state."""
    real = tracker._step

    def step(packed, **kw):
        st, ist, out = real(packed, **kw)
        x = out.track_x.clone()
        x[out.track_mask.nonzero()[:1, 0]] += 0.5
        return st, ist, out._replace(track_x=x)
    tracker._step = step


def prelim_altered(tracker):
    """An answer kept for the next scan altered where it is produced: a
    prelim's state in the initiator."""
    real = tracker._step

    def step(packed, **kw):
        st, ist, out = real(packed, **kw)
        f = run.fields(ist)
        f["p_x"] = f["p_x"].clone()
        f["p_x"][f["p_mask"].nonzero()[:1, 0]] += 5.0
        return st, type(ist)(**f), out
    tracker._step = step


FAULTS = dict(unchanged=unchanged, half_left_out=half_left_out,
              answer_altered=answer_altered, prelim_altered=prelim_altered)
