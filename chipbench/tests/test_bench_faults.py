"""A run with the timed path broken underneath comes out not correct: the
harness drives the rest of a run (every step but the look for a card) on
the CPU at tiny widths, once per fault a cell can have.  One card holds
every cell, so no cell has an exchange between chips to leave out.

The tiny cells' limit is 0.05: sound tiny runs read 0 to ~0.01 (the
tiny model's logits spread ~0.16, 22x less than qwen2-7b's)."""
import pytest
import torch

from chipbench.tests import tiny

LIMIT = 0.05


def _engine_cell():
    cell = tiny.engine_cell("qwen2-7b.chat-poisson", arrival="backlog")
    cell["check"]["limit"] = LIMIT
    return cell


def _prefill_cell():
    cell = tiny.prefill_cell()
    cell["check"]["limit"] = LIMIT
    return cell


def test_sound_runs_are_correct():
    assert tiny.run(_engine_cell(), tiny.DENSE)["correct"]
    assert tiny.run(_prefill_cell(), tiny.DENSE,
                    workload="qwen2-7b.score-prefill")["correct"]


def _kv_never_written(monkeypatch):
    from repro_torch.models import model
    monkeypatch.setattr(model, "_paged_write",
                        lambda pool, new, pos, tables, active: pool)


def _half_the_batch(monkeypatch):
    from repro_torch.serving import core
    step = core.BatchStep.__call__

    def half(self, cache, tokens, pos, active, tables):
        logits, cache = step(self, cache, tokens, pos, active, tables)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits, cache
    monkeypatch.setattr(core.BatchStep, "__call__", half)


def _token_altered(monkeypatch):
    from repro_torch.serving import scheduler
    sample = scheduler.sample_token

    def altered(cfg, logits, temperature, generator=None):
        return (sample(cfg, logits, temperature, generator) + 1) % cfg.vocab
    monkeypatch.setattr(scheduler, "sample_token", altered)


@pytest.mark.parametrize("fault", [_kv_never_written, _half_the_batch,
                                   _token_altered],
                         ids=["state-unchanged", "half-batch",
                              "token-altered"])
def test_engine_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = tiny.run(_engine_cell(), tiny.DENSE)
    assert not r["correct"], r["checks"]


def _attention_left_out(monkeypatch):
    from repro_torch.models import model
    monkeypatch.setattr(model, "attend",
                        lambda q, k, v, **kw: torch.zeros_like(q))


def _half_the_positions(monkeypatch):
    from repro_torch import serving
    make = serving.make_prefill

    def broken(cfg, rc, plan=None):
        run = make(cfg, rc, plan)

        def half(params, tokens):
            lg = run(params, tokens).clone()
            lg[:, lg.shape[1] // 2:] = 0
            return lg
        return half
    monkeypatch.setattr(serving, "make_prefill", broken)


def _answer_altered(monkeypatch):
    from repro_torch import serving
    make = serving.make_prefill

    def broken(cfg, rc, plan=None):
        run = make(cfg, rc, plan)
        return lambda params, tokens: run(params, tokens).roll(1, -1)
    monkeypatch.setattr(serving, "make_prefill", broken)


@pytest.mark.parametrize("fault", [_attention_left_out, _half_the_positions,
                                   _answer_altered],
                         ids=["attention-left-out", "half-positions",
                              "answer-altered"])
def test_prefill_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = tiny.run(_prefill_cell(), tiny.DENSE,
                 workload="qwen2-7b.score-prefill")
    assert not r["correct"], r["checks"]
