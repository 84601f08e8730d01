"""The row-plane replica: ``LocalExecutor`` over the row model.

The benchmark draws the weights on the card from the seed
(``reference.weights.rows_params``) and hands them to the executor; the
reference draws them again once the program's state is freed.
"""

from __future__ import annotations

import gc

from cost import bound_s
from cost.exchange import capacity, launch_bytes
from cost.model import rows_request_flops
from harness.sampling import sample_answers
from reference import rows as ref_rows
from reference.weights import rows_params

from . import common


class System:
    def __init__(self, cell, seed: int, device, kernel):
        self.cell = cell
        self.cfg = cell.config
        self.model = self.cfg["model"]
        self.ex_args = dict(self.cfg["executor_args"])
        self.seed = int(seed)
        self.device = device
        self.kernel = kernel
        self.executors = []

    def _shape(self):
        m = self.model
        return (m["num_hidden_layers"], m["hidden_size"],
                m["intermediate_size"], m["num_local_experts"])

    def _weights(self):
        S, d, h, E = self._shape()
        return rows_params(self.seed, S, d, h, E, self.device)

    def build(self):
        from dpu_operator_tpu_torch.serving.executor import LocalExecutor
        from dpu_operator_tpu_torch.serving.infer import serving_mesh
        a = dict(self.ex_args)
        mesh = serving_mesh(shape=a.pop("mesh"))
        ex = LocalExecutor(params=self._weights(), mesh=mesh,
                           device=self.device, kernel=self.kernel, **a)
        self.executors = [ex]
        return self.executors

    def server_opts(self) -> dict:
        return dict(self.cfg.get("server_args", {}))

    def counters(self, server) -> dict:
        return {"steps": sum(b.steps for b in server.pool.batchers)}

    def trace_launches(self, on: bool) -> None:
        pass

    def launch_bounds(self) -> dict:
        """Kernel 10's bound of one launch (seconds): the exchange's
        shape is fixed by the slots, the ep ranks and the capacity
        factor."""
        a = self.ex_args
        E = int(a["mesh"]["ep"])
        groups = int(a["mesh"].get("dp", 1)) * E
        cap = capacity(a["slots"] // groups, E, a["capacity_factor"])
        width = self.model["hidden_size"] * int(a["mesh"].get("dp", 1))
        return {"all_to_all": bound_s(0.0, launch_bytes(E, cap, width))}

    def request_flops(self, traffic, rec) -> float:
        S, d, h, E = self._shape()
        return rows_request_flops(len(rec["tokens"]), d=d, ffn=h,
                                  experts=E, layers=S)

    def free(self) -> None:
        self.executors = []
        gc.collect()
        common.empty_cache(self.device)

    def check(self, traffic, answered, control: bool = False):
        limits = self.cfg["correct"]
        picked = sample_answers(answered, self.seed, limits["sample"],
                                size=lambda r: len(r["tokens"]))
        W = self._weights()
        got = ref_rows.judge(W, [traffic.prompt(r["i"]) for r in picked],
                             [r["tokens"] for r in picked], control=control)
        del W
        common.empty_cache(self.device)
        served = sum(len(r["tokens"]) for r in picked)
        common.log(f"check: {got['tokens']} of the {served} tokens served "
                   f"to {len(picked)} answers compared")
        compares = common.compare(got["served"], got["tokens"], limits)
        readings = (common.control_readings(got["control"], got["tokens"],
                                            limits) if control else {})
        return compares, readings
