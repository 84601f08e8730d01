"""A whole run with the timed path broken underneath: ``correct`` must come
out false, once for each fault a cell can have. The harness's look for a
card is skipped (the run is on the CPU); the rest is the run as it is."""

import pytest
import torch

from conftest import run_tiny, tiny_paged, tiny_rows


def altered_paged_token(monkeypatch):
    from dpu_operator_tpu_torch.serving.kvcache import paged
    tail = paged._PagedModel._tail

    def bad(self, x, o, n_new):
        return (tail(self, x, o, n_new) + 1) % self.vocab

    monkeypatch.setattr(paged._PagedModel, "_tail", bad)


def paged_state_unchanged(monkeypatch):
    """The step appends nothing to the pools: it leaves its state as it
    found it."""
    from dpu_operator_tpu_torch.serving.kvcache import paged
    plain = paged.paged_attn_step_plain

    def bad(*args):
        *head, kpool, vpool = args
        return plain(*head, kpool.clone(), vpool.clone())

    monkeypatch.setattr(paged, "paged_attn_step_plain", bad)


def altered_row_token(monkeypatch):
    from dpu_operator_tpu_torch.serving import infer
    fwd = infer.DecodeStep._fwd

    def bad(self, x):
        y, tok = fwd(self, x)
        return y, (tok + 1) % self.d

    monkeypatch.setattr(infer.DecodeStep, "_fwd", bad)


def row_state_unchanged(monkeypatch):
    from dpu_operator_tpu_torch.serving import infer

    def bad(self, x):
        return x, x.argmax(dim=1).to(torch.int32)

    monkeypatch.setattr(infer.DecodeStep, "_fwd", bad)


def row_exchange_left_out(monkeypatch):
    from dpu_operator_tpu_torch.serving import infer
    monkeypatch.setattr(infer, "pick_exchange",
                        lambda kernel, E: (lambda x, n: x))


@pytest.mark.parametrize("cell, fault", [
    ("paged", altered_paged_token),
    ("paged", paged_state_unchanged),
    ("rows", altered_row_token),
    ("rows", row_state_unchanged),
    ("rows", row_exchange_left_out),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_paged("chat") if cell == "paged" else tiny_rows())
    res = out["result"]
    assert res["attempted"] > 0
    assert res["correct"] is False, res["compared"]
