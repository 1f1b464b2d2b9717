"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program's calls, with the rest
of the run as the benchmark drives it (on the CPU, without the look for
a card). A frames cell: a frame that never changes, half a frame left
out, one block of a frame altered. The fit: a step that leaves its state
unchanged, half the image left out of the loss (the mean over the rest),
and a loss altered where it is produced. One chip, so no exchange between
chips to leave out."""

import pytest
import torch
import _tiny

from rmbench import system

FRAMES = ["ct256_bone.orbit", "luna16_chest.clip_drag", "ct256_bone.fly",
          "ct256_bone.window_drag"]


def _stale(render):
    first = {}

    def wrapped(self, state):
        img = render(self, state)
        return first.setdefault("img", img.clone())

    return wrapped


def _half(render):
    def wrapped(self, state):
        img = render(self, state).clone()
        img[img.shape[0] // 2:] = 0.0
        return img

    return wrapped


def _block(render):
    def wrapped(self, state):
        img = render(self, state).clone()
        img[8:16, 8:16] = 1.0 - img[8:16, 8:16]
        return img

    return wrapped


@pytest.mark.parametrize("fault", [_stale, _half, _block])
@pytest.mark.parametrize("name", FRAMES)
def test_frames_fault_is_not_correct(monkeypatch, name, fault):
    monkeypatch.setattr(system.Viewer, "render",
                        fault(system.Viewer.render))
    r = _tiny.run(_tiny.cell(name), seconds=0.5)
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


def _unchanged(step):
    def wrapped(self):
        saved = [t.detach().clone() for t in self.leaves]
        loss = step(self)
        with torch.no_grad():
            for t, s in zip(self.leaves, saved):
                t.copy_(s)
        return loss

    return wrapped


def _half_loss(step):
    def wrapped(self):
        image_loss, smooth = self.loss_terms
        h = self.height // 2
        self.loss_terms = (lambda img, tgt: image_loss(img[:h], tgt[:h]),
                           smooth)
        return step(self)

    return wrapped


def _altered_loss(step):
    def wrapped(self):
        return step(self) * 1.1

    return wrapped


@pytest.mark.parametrize("fault", [_unchanged, _half_loss, _altered_loss])
def test_fit_fault_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(system.FitStep, "step", fault(system.FitStep.step))
    r = _tiny.run(_tiny.cell("ct256_bone.fit"))
    assert not r["correct"], r["checks"]
