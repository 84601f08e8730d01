"""The references against the port's CPU path, at small sizes."""

import numpy as np
import torch

from conftest import SEED, run_tiny, tiny_paged, tiny_rows
from reference import paged as ref_paged
from reference import rows as ref_rows
from reference.encode import encode_prompt
from reference.weights import paged_params, rows_params


def test_paged_weight_draw_is_the_programs():
    from dpu_operator_tpu_torch.serving.kvcache.paged import \
        build_paged_params
    mine = paged_params(7, 50, 16, 32, 32)
    theirs = build_paged_params(7, 50, 16, 32)
    assert list(mine) == list(theirs)
    for k in mine:
        assert np.array_equal(mine[k], theirs[k]), k


def test_prompt_encoder_is_the_programs():
    from dpu_operator_tpu_torch.serving.api import encode_prompt as theirs
    for text in ("bench-1-0", "bench-4294979641-77", "x"):
        assert np.array_equal(encode_prompt(text, 64), theirs(text, 64))


def test_rows_draw_is_seeded_on_the_device():
    a = rows_params(SEED, 2, 8, 16, 2, "cpu")
    b = rows_params(SEED, 2, 8, 16, 2, "cpu")
    c = rows_params(SEED + 1, 2, 8, 16, 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w1"], c["w1"])
    assert a["moe_w1"].shape == (2, 2, 8, 16)


def test_int8_rule_sets_a_block_scale_once():
    # Block size 4, prompt of 6 in chunks of 4: block 0 is written by
    # step 0 (positions 0-3), block 1 by step 1 (positions 4-5), whose
    # scale the later single-position steps 6 and 7 keep.
    vals = torch.zeros(8, 1, 1)
    vals[:, 0, 0] = torch.tensor([1., -2., 0.5, 1., 3., 1., 100., 1.])
    groups = ref_paged.write_groups(8, 6, 4)
    assert groups.tolist() == [0, 0, 0, 0, 1, 1, 2, 3]
    c = 1.5 / 127
    out = ref_paged.int8_kv(vals, groups, 4, c)[:, 0, 0]
    s1 = 3.0 * c
    assert torch.allclose(out[6], torch.tensor(127 * s1))    # clipped
    assert torch.allclose(out[4], torch.round(torch.tensor(3 / s1)) * s1)


def test_paged_reference_matches_the_port():
    out = run_tiny(tiny_paged("chat"))
    c = out["result"]["compared"]
    assert out["result"]["correct"], c
    assert c["served_gap"]["value"] == 0.0
    assert c["tokens_compared"]["value"] >= 16


def test_paged_reference_matches_the_port_with_shared_prefixes():
    out = run_tiny(tiny_paged("prefix"))
    assert out["result"]["correct"], out["result"]["compared"]
    hits = [r.get("cached_tokens", 0) for r in out["window"].answered]
    assert max(hits) > 0


def test_rows_reference_matches_the_port():
    out = run_tiny(tiny_rows())
    c = out["result"]["compared"]
    assert out["result"]["correct"], c
    assert c["served_gap"]["value"] == 0.0


def test_rows_draw_keeps_a_state_s_size_over_the_steps():
    # Gain 1 on every product let the states die away within a few steps
    # (and every routing fall to one expert); He's gain on the products
    # that read a ReLU keeps them at their size.
    W = rows_params(SEED, 4, 256, 512, 8, "cpu")
    prompts = [f"prompt {i}" for i in range(16)]
    states, margins = ref_rows.trajectory(W, prompts, 32)
    assert states.shape[0] == 32
    rms = states.pow(2).mean(dim=(1, 2)).sqrt()
    # Past the first steps' settling, the size holds.
    assert 0.5 < float(rms[-1] / rms[7]) < 2.0, rms
    # Most steps route every row with a margin the comparison can use.
    share = (margins >= ref_rows.MIN_GATE_MARGIN).float().mean()
    assert float(share) > 0.9, share
