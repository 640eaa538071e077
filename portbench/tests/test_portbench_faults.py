"""A run with its timed path broken underneath comes out not correct, and
the control (the reference in TF32) fails the limits the cells hold.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size, under the limits of the real cell."""

import pytest
import torch

from icassp2022_depression_tpu_torch.frontend import audio as audio_fe
from icassp2022_depression_tpu_torch.models import elmo_pretrained as ep
from icassp2022_depression_tpu_torch.serving import predictors
from portbench import run as bench_run
from portbench.harness import registry
from portbench.tests import tiny

CELLS = {"fuse_clf.interactive": ("fuse_clf", "interactive"),
         "fuse_clf.cohort": ("fuse_clf", "cohort"),
         "audio_clf.interactive": ("audio_clf", "interactive")}


def _run(cell_name, **kw):
    task, family = CELLS[cell_name]
    limits = registry.workload(cell_name)["limits"]
    result, _ = bench_run.execute(tiny.cell(task, family, limits, **kw))
    return result


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result
    assert result["failed"] == 0 and result["attempted"] > 0


def _nudge(t: torch.Tensor) -> torch.Tensor:
    """The first value of every row moved by a hundredth of the largest
    magnitude: every answer altered where it is produced (the check reads
    a sample of the speakers)."""
    t = t.clone()
    t[:, 0] += 0.01 * t.abs().max()
    return t


def _answer(monkeypatch):
    orig = predictors.Predictor.predict_features

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw).copy()
        out[:, 0] += 1e-3
        return out

    monkeypatch.setattr(predictors.Predictor, "predict_features", altered)


def _audio(monkeypatch):
    orig = audio_fe.extract_batch
    monkeypatch.setattr(audio_fe, "extract_batch",
                        lambda *a, **kw: _nudge(orig(*a, **kw)))


def _text(monkeypatch):
    orig = ep.PretrainedElmo.embed_sentences
    monkeypatch.setattr(ep.PretrainedElmo, "embed_sentences",
                        lambda self, s, **kw: _nudge(orig(self, s, **kw)))


def _half_batch(monkeypatch):
    """Half of a call's speakers left out: their features are the other
    half's."""
    orig = predictors.Predictor._audio_feature_rows

    def halved(self, waves, rates, bases, keys):
        rows = orig(self, waves, rates, bases, keys)
        half = (len(rows) + 1) // 2
        return rows[:half] + rows[:len(rows) - half]

    monkeypatch.setattr(predictors.Predictor, "_audio_feature_rows", halved)


FAULTS = {"answer": _answer, "audio_feature": _audio,
          "text_feature": _text, "half_batch": _half_batch}
CASES = [(c, f) for c in sorted(CELLS) for f in FAULTS
         if not (f == "text_feature" and c.startswith("audio"))
         and not (f == "half_batch" and "cohort" not in c)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run(cell)
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_the_limits(cell):
    """The control's numbers (TF32 products, emulated on the CPU) against
    the cell's limits: it must fail at least one."""
    task, family = CELLS[cell]
    limits = registry.workload(cell)["limits"]
    run = registry.driver("closed_loop").run(
        tiny.cell(task, family, limits, control=True))
    assert run.correct
    assert run.control and not all(c.ok for c in run.control), run.control


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged."""
    from icassp2022_depression_tpu_torch.train import optim

    monkeypatch.setattr(optim.StackedAdam, "step", lambda self, active: None)


def _half_rows(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from icassp2022_depression_tpu_torch.train import trainers

    orig = trainers.masked_cross_entropy_on_probs

    def halved(probs, labels, mask, num_classes):
        mask = mask.clone()
        mask[..., mask.shape[-1] // 2:] = 0
        return orig(probs, labels, mask, num_classes)

    monkeypatch.setattr(trainers, "masked_cross_entropy_on_probs", halved)


def _loss_altered(monkeypatch):
    """The step's loss altered where it is produced."""
    from icassp2022_depression_tpu_torch.train import trainers

    orig = trainers.masked_cross_entropy_on_probs
    monkeypatch.setattr(trainers, "masked_cross_entropy_on_probs",
                        lambda *a: orig(*a) * (1 + 1e-3))


def _test_answer_altered(monkeypatch):
    """The evaluation's answer altered where it is produced: the first
    test row's two probabilities swapped."""
    from icassp2022_depression_tpu_torch.train import loop

    orig = loop.model_fns

    def fns(model, loss_fn):
        train_loss, eval_fn = orig(model, loss_fn)

        def swapped(xs):
            out = eval_fn(xs).clone()
            out[..., 0, :] = out[..., 0, :].flip(-1)
            return out

        return train_loss, swapped

    monkeypatch.setattr(loop, "model_fns", fns)


def _gate_altered(monkeypatch):
    """The track's answer altered where it is produced: every fold's gated
    epoch one later."""
    from icassp2022_depression_tpu_torch.train import loop

    orig = loop.FoldRun.results

    def results(self):
        out = orig(self)
        for best, _, _ in (out if self.folded else [out]):
            best["epoch"] += 1
        return out

    monkeypatch.setattr(loop.FoldRun, "results", results)


TRAIN_FAULTS = {"unchanged_state": _unchanged_state,
                "half_rows": _half_rows, "loss_altered": _loss_altered,
                "test_answer_altered": _test_answer_altered,
                "gate_altered": _gate_altered}


def _train(**kw):
    limits = registry.workload("audio_clf.train")["limits"]
    return registry.driver("tracks").run(tiny.train_cell(limits, **kw))


def test_sound_training_run_is_correct():
    run = _train()
    assert run.correct, run.compared
    assert run.metrics["train_samples_per_s"][0] > 0


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_planted_training_fault_is_not_correct(fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    assert not _train().correct


def test_training_control_fails_the_limit():
    run = _train(control=True)
    assert run.correct and not all(c.ok for c in run.control), run.control


def _card_run(cell: str, seed: int, control: bool = False):
    from portbench.harness.cell import Cell

    w = registry.workload(cell)
    mix = registry.traffic(w["traffic"])
    run = registry.driver(mix["driver"]).run(Cell(
        name=cell, config=registry.config(w["config"]), traffic=mix,
        workload=w, seed=seed, seconds=2.0, trace=False, device="cuda",
        control=control))
    for c in run.compared + run.control:
        print(f"{cell} seed {seed} {c.name} {c.value!r} limit {c.limit!r}")
    return run


CARD_SEEDS = (11, 2**31 + 12, 4001)


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS) + ["audio_clf.train"])
def test_control_on_the_card(card, cell):
    """The control at the cell's own configuration and mix on the card
    (a short window): the program passes, the control fails."""
    for seed in CARD_SEEDS:
        run = _card_run(cell, seed, control=True)
        assert run.correct, run.compared
        assert not all(c.ok for c in run.control), run.control


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_training_faults_on_the_card(card, fault, monkeypatch):
    """Each fault a training cell can have, at the cell's own size."""
    TRAIN_FAULTS[fault](monkeypatch)
    for seed in CARD_SEEDS:
        assert not _card_run("audio_clf.train", seed).correct
