"""The paged-KV replica: ``PagedKVExecutor`` over the paged model.

The executor draws its own weights from the seed on the host. The
reference draws them again with its frozen copy of that draw in the check,
after the window and once the program's state is freed, so that the draw
neither counts in set-up nor competes with it for the host.
"""

from __future__ import annotations

import gc

import numpy as np

from cost import bound_s
from cost.attn import attn_cost
from cost.model import paged_request_flops
from harness.sampling import sample_answers
from reference import paged as ref_paged
from reference.weights import paged_draws

from . import common


class System:
    def __init__(self, cell, seed: int, device, kernel):
        self.cell = cell
        self.cfg = cell.config
        self.model = self.cfg["model"]
        self.ex_args = dict(self.cfg["executor_args"])
        self.seed = int(seed)
        # The program seeds a numpy RandomState: 32 bits.
        self.weight_seed = self.seed % (2 ** 32)
        self.device = device
        self.kernel = kernel
        self.executors = []
        self._launches = []
        self._recording = False

    # -- set-up ---------------------------------------------------------------

    def _dims(self):
        m = self.model
        return (self.weight_seed, m["vocab_size"], m["hidden_size"],
                self.ex_args["max_blocks_per_req"]
                * self.ex_args["block_size"], m["mlp_width"])

    def build(self):
        from dpu_operator_tpu_torch.serving.kvcache.executor import \
            PagedKVExecutor
        m = self.model
        ex = PagedKVExecutor(
            vocab=m["vocab_size"], d=m["hidden_size"],
            heads=m["num_attention_heads"], seed=self.weight_seed,
            device=self.device, kernel=self.kernel, **self.ex_args)
        self.executors = [ex]
        return self.executors

    def server_opts(self) -> dict:
        return dict(self.cfg.get("server_args", {}))

    def counters(self, server) -> dict:
        ex = self.executors[0]
        return {"steps": sum(b.steps for b in server.pool.batchers),
                "prefill_tokens": ex.prefill_tokens,
                "decode_tokens": ex.decode_tokens}

    # -- traced run -----------------------------------------------------------

    def trace_launches(self, on: bool) -> None:
        """Record each dispatched step's ``ctx`` and ``n_new`` (host
        arrays of the step plan, no device read) while ``on``."""
        ex = self.executors[0]
        if "_dispatch" not in ex.__dict__:
            inner = ex._dispatch

            def dispatch(plan):
                if self._recording:
                    self._launches.append((plan.ctx.copy(),
                                           plan.n_new.copy()))
                return inner(plan)

            ex._dispatch = dispatch
        self._recording = on

    def launch_bounds(self) -> dict:
        """Kernel 1's mean bound over the launches recorded (seconds)."""
        a = self.ex_args
        m = self.model
        bounds = []
        for ctx, n_new in self._launches:
            nbytes, flops = attn_cost(
                ctx, n_new, slots=a["slots"], chunk=a["prefill_chunk"],
                heads=m["num_attention_heads"],
                d_head=m["hidden_size"] // m["num_attention_heads"],
                block_size=a["block_size"], pool_dtype=a["pool_dtype"])
            bounds.append(bound_s(flops, nbytes))
        return {"paged_attn": (sum(bounds) / len(bounds)) if bounds
                else None}

    def request_flops(self, traffic, rec) -> float:
        m = self.model
        return paged_request_flops(
            traffic.request(rec["i"]).prompt_len, len(rec["tokens"]),
            rec.get("cached_tokens", 0), d=m["hidden_size"],
            heads=m["num_attention_heads"], vocab=m["vocab_size"],
            mlp=m["mlp_width"])

    def free(self) -> None:
        self.executors = []
        gc.collect()
        common.empty_cache(self.device)

    # -- the check ------------------------------------------------------------

    def _reference_weights(self):
        """The reference's draw, each array moved to the device as it is
        drawn."""
        import torch
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in paged_draws(*self._dims())}

    def ref_cfg(self) -> dict:
        a = self.ex_args
        if a["prefill_chunk"] != a["block_size"]:
            raise ValueError("the reference writes prompts in steps of "
                             "the chunk from position 0, which is what "
                             "the program does when chunk == block_size")
        if a["prefill_budget"] < a["slots"] * a["prefill_chunk"]:
            raise ValueError("a prefill budget under slots * chunk lets "
                             "chunks start off the block grid")
        return {"heads": self.model["num_attention_heads"],
                "block_size": a["block_size"], "chunk": a["prefill_chunk"],
                "max_context": a["max_blocks_per_req"] * a["block_size"],
                "scale_c": float(np.float32(1.5 / 127.0))}

    def check(self, traffic, answered, control: bool = False):
        import time
        t0 = time.monotonic()
        W = self._reference_weights()
        common.log(f"check: reference weights drawn and on the card in "
                   f"{time.monotonic() - t0:.3f} s")
        cfg = self.ref_cfg()
        limits = self.cfg["correct"]
        picked = sample_answers(
            answered, self.seed, limits["sample"],
            size=lambda r: traffic.request(r["i"]).prompt_len
            + len(r["tokens"]))
        worst, worst_c, tokens = 0.0, 0.0, 0
        for rec in picked:
            got = ref_paged.judge(W, traffic.prompt(rec["i"]),
                                  rec["tokens"], cfg, control=control)
            worst = max(worst, got["served"])
            worst_c = max(worst_c, got.get("control", 0.0))
            tokens += got["tokens"]
        del W
        common.empty_cache(self.device)
        compares = common.compare(worst, tokens, limits)
        readings = (common.control_readings(worst_c, tokens, limits)
                    if control else {})
        return compares, readings
