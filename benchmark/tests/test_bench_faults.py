"""The check sees each fault a cell can have, planted under the timed path
in a CPU rehearsal: ``correct`` comes out false. The faults: an answer
altered where it is produced, half of the batch (or of the requests) left
out, and a step that returns its state (the window carry) unchanged. The
cells run on one card, so no exchange between cards can be left out."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.tests._cpu import rehearse

BATCH, SERVE = "batch_music_q3", "serve_speech_16k"


def _altered_batch(monkeypatch):
    from lewton_tpu_torch.parallel.batch import BatchDecoder

    orig = BatchDecoder.decode_streams_i16

    def decode(self, streams, **kw):
        outs = orig(self, streams, **kw)
        for o in outs:
            o[len(o) // 2] ^= 0x40  # one sample of every answer
        return outs
    monkeypatch.setattr(BatchDecoder, "decode_streams_i16", decode)


def _half_batch(monkeypatch):
    from lewton_tpu_torch.parallel.batch import BatchDecoder

    orig = BatchDecoder.decode_streams_i16

    def decode(self, streams, **kw):
        half = orig(self, streams[: len(streams) // 2], **kw)
        return half + [np.zeros((0, self.cs.channels), np.int16)] * (
            len(streams) - len(half))
    monkeypatch.setattr(BatchDecoder, "decode_streams_i16", decode)


def _altered_serve(monkeypatch):
    from lewton_tpu_torch.serve import StreamingScheduler

    orig = StreamingScheduler.poll

    def poll(self, sid):
        out = orig(self, sid)
        if out.size:
            out = out.copy()
            out[0, 0] ^= 0x40
        return out
    monkeypatch.setattr(StreamingScheduler, "poll", poll)


def _half_serve(monkeypatch):
    from lewton_tpu_torch.serve import StreamingScheduler

    orig = StreamingScheduler.poll

    def poll(self, sid):
        out = orig(self, sid)
        return out[:0] if isinstance(sid, int) and sid % 2 else out
    monkeypatch.setattr(StreamingScheduler, "poll", poll)


def _state_unchanged(monkeypatch):
    from lewton_tpu_torch.parallel.batch import TransferSlots

    orig = TransferSlots.dispatch

    def dispatch(self, slot, fr, lens, carry, *a, **kw):
        saved = [c.clone() for c in carry]
        res = orig(self, slot, fr, lens, carry, *a, **kw)
        for c, s in zip(res[2], saved):
            c.copy_(s)
        return res
    monkeypatch.setattr(TransferSlots, "dispatch", dispatch)


@pytest.mark.parametrize("cell,fault", [
    (BATCH, _altered_batch), (BATCH, _half_batch), (BATCH, _state_unchanged),
    (SERVE, _altered_serve), (SERVE, _half_serve), (SERVE, _state_unchanged)],
    ids=["batch-altered", "batch-half", "batch-state", "serve-altered",
         "serve-half", "serve-state"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res, _, _ = rehearse(cell)
    assert res["correct"] is False, res["check"]
