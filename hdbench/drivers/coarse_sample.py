"""Window of the coarse sampling cells: one client sends requests back to
back, each a batch of molecules for ``hierdiff_torch.sampling.coarse``'s
``sample_coarse`` (or, with a pocket, ``sample_coarse_pocket``), as
``sampling/cli.py`` ``cmd_coarse`` runs them: the model built by
``build_coarse_from_cfg`` in float32 elementwise, masks from the request's
node counts copied to the card, all reverse steps, then the output read
back.

The benchmark makes every draw of noise (``noise=``: draw k of a request
comes from a generator seeded with the request's base seed plus k) and
taps the model's two reverse-process calls to keep the program's state at
the checked steps (``reference/sample_check.py``).

Mix parameters (``traffic/mixes/<name>.json``): ``histogram``, ``batch``
molecules a request, ``steps`` (null: all T), ``checked_steps`` checked
reverse steps a request besides the first and the last, ``pocket_residues``
(absent: no pocket), ``trace_steps`` reverse steps in the profiled stretch.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from hdbench import roofline, traffic
from hdbench.reference import coarse as ref
from hdbench.reference.sample_check import Request, request_gaps, update_control_gaps, worst
from hdbench.weights import make_weights, shapes_of


def derived_seed(*parts: int) -> int:
    """A 62-bit seed from the run's seed and indices."""
    words = np.random.SeedSequence([int(p) % (2 ** 63) for p in parts]).generate_state(2, np.uint32)
    return (int(words[0]) << 30 ^ int(words[1])) & ((1 << 62) - 1)


class Noise:
    """``noise[k]``: the raw standard normals of draw k of one request,
    (B, N, 3 + F), from a generator of the card seeded with base + k."""

    def __init__(self, shape, base: int, device: torch.device):
        self.shape, self.base, self.device = shape, base, device
        self.gen = torch.Generator(device=device)

    def __getitem__(self, k: int) -> torch.Tensor:
        self.gen.manual_seed(self.base + int(k))
        return torch.randn(self.shape, generator=self.gen, device=self.device)


class Tap:
    """Wraps the model's ``sample_zs_stats``, ``phi`` and
    ``sample_x_given_z0_stats`` on the instance and hooks its EGNN's first
    GCL: counts the reverse steps, keeps the program's state at the
    requested steps (its input, gammas and noise prediction on the molecule
    rows, and the first GCL's output over all rows), and calls
    ``on_step(k)`` before step k (k = n + 1 is the final draw)."""

    FIRST_GCL = "dynamics.egnn.e_block_0.gcl_0"

    def __init__(self, model):
        self.step_fn = model.sample_zs_stats
        self.phi_fn = model.phi
        self.final_fn = model.sample_x_given_z0_stats
        model.sample_zs_stats = self.step
        model.phi = self.phi
        model.sample_x_given_z0_stats = self.final
        model.get_submodule(self.FIRST_GCL).register_forward_hook(self.first_gcl)
        self.on_step = None
        self.begin((), (), 0)

    def begin(self, keep_z, keep_eps, rows: int) -> None:
        self.k = 0
        self.in_final = False
        self.keep_z, self.keep_eps, self.rows = set(keep_z), set(keep_eps), rows
        self.z: Dict[int, torch.Tensor] = {}
        self.eps: Dict[int, torch.Tensor] = {}
        self.gammas: Dict[int, tuple] = {}
        self.gcl: Dict[int, torch.Tensor] = {}
        self.z0 = self.eps0 = None

    def step(self, z, gamma_s, gamma_t, *args, **kwargs):
        self.k += 1
        if self.on_step is not None:
            self.on_step(self.k)
        if self.k in self.keep_z:
            self.z[self.k] = z[:, :self.rows].clone()
        if self.k in self.keep_eps:
            self.gammas[self.k] = (gamma_s.clone(), gamma_t.clone())
        return self.step_fn(z, gamma_s, gamma_t, *args, **kwargs)

    def phi(self, *args, **kwargs):
        out = self.phi_fn(*args, **kwargs)
        if self.in_final:
            if self.keep_z:
                self.eps0 = out.clone()
        elif self.k in self.keep_eps:
            self.eps[self.k] = out[:, :self.rows].clone()
        return out

    def first_gcl(self, module, inputs, output):
        if not self.in_final and self.k in self.keep_eps:
            self.gcl[self.k] = output.clone()

    def final(self, z0, *args, **kwargs):
        self.in_final = True
        if self.on_step is not None:
            self.on_step(self.k + 1)
        if self.keep_z:
            self.z0 = z0.clone()
        return self.final_fn(z0, *args, **kwargs)


class CoarseSampling:
    """Model, traffic and window of one coarse sampling cell."""

    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        from hierdiff_torch.config import CoarseModelConfig
        from hierdiff_torch.ops import _build
        from hierdiff_torch.sampling.cli import build_coarse_from_cfg

        self.config, self.mix, self.seed, self.device = config, mix, int(seed), device
        self.model_cfg = dict(config["coarse"])
        ref.check_config(self.model_cfg)
        if device.type == "cuda":
            _build.build_all()
        cfg = CoarseModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                   for k, v in self.model_cfg.items()})
        self.model = build_coarse_from_cfg(cfg, mix["compute_dtype"], device)
        self.weights = make_weights(shapes_of(self.model), self.seed, device)
        self.model.load_state_dict(self.weights, strict=True)
        self.tap = Tap(self.model)
        self.n_steps = int(mix["steps"] or self.model_cfg["timesteps"])
        self.batch = int(mix["batch"])
        self.counts = traffic.stratified_counts(mix["histogram"], self.batch)
        self.rows = int(self.counts.max())
        self.k_pocket = int(mix.get("pocket_residues", 0))
        self.width = 3 + self.model.in_node_nf
        self.done: List[dict] = []

    # --- traffic -------------------------------------------------------------

    def request(self, r: int) -> dict:
        """Request r: the counts in an order drawn from the seed, the masks on
        the card, the pocket and the base seed of its draws."""
        rng = np.random.default_rng(derived_seed(self.seed, r, 1))
        counts = rng.permutation(self.counts)
        nm, em = traffic.complete_masks(counts, self.rows)
        req = {"r": r, "counts": counts,
               "node_mask": torch.from_numpy(nm).to(self.device),
               "edge_mask": torch.from_numpy(em).to(self.device),
               "noise": Noise((self.batch, self.rows, self.width), derived_seed(self.seed, r, 2),
                              self.device)}
        if self.k_pocket:
            pk = traffic.pocket(rng, self.k_pocket)
            req["pocket"] = {k: torch.from_numpy(np.repeat(v, self.batch, axis=0)).to(self.device)
                             for k, v in pk.items()}
        return req

    def sample(self, req: dict, steps=None) -> torch.Tensor:
        from hierdiff_torch.sampling.coarse import sample_coarse, sample_coarse_pocket

        if "pocket" not in req:
            return sample_coarse(self.model, req["node_mask"], req["edge_mask"], steps=steps,
                                 packed=True, noise=req["noise"])
        pk = req["pocket"]
        return sample_coarse_pocket(self.model, req["node_mask"], req["edge_mask"],
                                    pk["protein_feat"], pk["protein_pos"],
                                    pk["protein_feat_mask"], pk["protein_edge_mask"],
                                    steps=steps, packed=True, noise=req["noise"])

    def checked_steps(self, r: int) -> List[int]:
        rng = np.random.default_rng(derived_seed(self.seed, r, 3))
        inner = rng.choice(np.arange(2, self.n_steps), size=int(self.mix["checked_steps"]),
                           replace=False) if self.n_steps > 2 else []
        return sorted({1, self.n_steps, *(int(k) for k in inner)})

    def warm_up(self) -> None:
        """One short chain at the requests' shape (two strided steps and
        the final draw): every kernel and shape the window uses."""
        self.tap.begin((), (), self.rows)
        self.sample(self.request(-1), steps=2)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- the window ----------------------------------------------------------

    def run_request(self, r: int, keep: bool) -> dict:
        req = self.request(r)
        checked = self.checked_steps(r) if keep else []
        keep_z = set(checked) | {k + 1 for k in checked if k < self.n_steps} | ({1} if keep else set())
        self.tap.begin(keep_z, checked, self.rows)
        out = self.sample(req)
        out_host = out.float().cpu()   # the read-back cmd_coarse makes
        req.update(out=out, finite=bool(torch.isfinite(out_host).all()), checked=checked,
                   z=self.tap.z, eps=self.tap.eps, gammas=self.tap.gammas, gcl=self.tap.gcl,
                   z0=self.tap.z0, eps0=self.tap.eps0)
        return req

    def window(self, seconds: float) -> dict:
        """Requests back to back; none starts after ``seconds``; the one in
        flight finishes and counts."""
        t0 = time.perf_counter()
        r = 0
        while time.perf_counter() - t0 < seconds:
            self.done.append(self.run_request(r, keep=True))
            r += 1
        t1 = time.perf_counter()
        return {"elapsed_s": t1 - t0, "requests": r}

    # --- work counts ---------------------------------------------------------

    def request_work(self) -> dict:
        """Real edges and nodes of a reverse step and of the final draw."""
        edges, nodes = roofline.complete_graph_work(self.counts)
        final = (edges, nodes)
        if self.k_pocket:
            k = self.k_pocket
            edges += self.batch * k * (k - 1) + 2 * k * float(sum(self.counts))
            nodes += self.batch * k
        return {"step": (edges, nodes), "final": final,
                "shape": (self.batch, self.rows + self.k_pocket)}

    def window_flops(self, requests: int) -> float:
        w = self.request_work()
        h, blocks, gcls = (self.model_cfg["hidden_nf"], self.model_cfg["n_layers"],
                           self.model_cfg["inv_sublayers"])
        per = (self.n_steps * roofline.egnn_forward_flops(*w["step"], h=h, blocks=blocks, gcls=gcls,
                                                          f_in=self.width - 2)
               + roofline.egnn_forward_flops(*w["final"], h=h, blocks=blocks, gcls=gcls,
                                             f_in=self.width - 2))
        return requests * per

    # --- the check -----------------------------------------------------------

    def as_request(self, req: dict) -> Request:
        pk = req.get("pocket")
        return Request(req["node_mask"], req["edge_mask"], req["noise"].__getitem__,
                       self.n_steps, req["z"], req["eps"], req["gammas"], req["gcl"], req["z0"],
                       req["eps0"], req["out"], req["checked"],
                       pocket_tokens=None if pk is None else pk["protein_feat"],
                       pocket_pos=None if pk is None else pk["protein_pos"],
                       cross_edges=bool(self.model_cfg.get("pocket_cross_edges", True)))

    def gaps(self) -> dict:
        """The worst of each gap over every finished request. On the card
        the reference's EGNN products take bf16 operands, as the kernels'
        do; the CPU's plain route is float32 throughout, and so is the
        reference there."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out: Dict[str, float] = {}
        self.eps_by_step = []
        with torch.no_grad():
            for req in self.done:
                gaps = request_gaps(self.weights, self.model_cfg, self.as_request(req),
                                    bf16_products=self.device.type == "cuda")
                self.eps_by_step += gaps.pop("eps_by_step")
                for k, v in gaps.items():
                    out[k] = worst(out.get(k, 0.0), v)
        return out

    def free_program(self) -> None:
        """Drop the program's model before the reference runs."""
        self.tap = self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the profiled stretch ------------------------------------------------

    def profile_stretch(self, r: int) -> dict:
        """One more request of the same traffic: ``trace_steps`` reverse
        steps from its middle under the profiler with the CUDA activity
        alone, then as many with the CPU activity too (``hdbench/trace.py``)."""
        from hdbench import trace

        n = int(self.mix["trace_steps"])
        k0 = max(1, self.n_steps // 2 - n)
        stretches = trace.Stretches(self.device, [(k0, k0 + n, False), (k0 + n, k0 + 2 * n, True)])
        self.tap.on_step = stretches.at_step
        self.run_request(r, keep=False)
        self.tap.on_step = None
        summary, gaps = stretches.read()
        summary["idle_gaps"] = gaps
        summary["steps"] = n
        return summary


def bounds_of(cell: CoarseSampling, summary: dict, clock_hz: float, n_sms: int) -> dict:
    """Least seconds for every wrapper launch the stretch traced: every
    launch of a reverse step has the step's shape."""
    w = cell.request_work()
    b, n = w["shape"]
    h = cell.model_cfg["hidden_nf"]
    out = {}
    for wrapper in ("fused_gcl", "fused_coord_update"):
        launches = summary["launches"].get(wrapper, 0)
        ms = roofline.bound(*roofline.WORK[wrapper](*w["step"], b, n, h=h), clock_hz, n_sms)[0]
        out[wrapper] = launches * ms * 1e-3
        if launches != summary["counter_launches"].get(wrapper, 0):
            print(f"hdbench: {wrapper}: {launches} launches in the trace, "
                  f"{summary['counter_launches'].get(wrapper, 0)} counted", file=sys.stderr)
    return out


def run(bench) -> dict:
    """One run of a coarse sampling cell (``bench``: see ``hdbench/run.py``)."""
    cell = CoarseSampling(bench.config, bench.mix, bench.seed, bench.device)
    cell.warm_up()
    bench.setup_done()
    win = cell.window(bench.seconds)
    state = bench.card_state()
    molecules = cell.batch * win["requests"]
    failed = sum(1 for req in cell.done if not req["finite"])
    result = {"attempted": win["requests"], "failed": failed,
              "e2e": {"sample_molecules_per_s": molecules / win["elapsed_s"]},
              "memory_peak_bytes": bench.memory_peak(), "card_state": state}
    if bench.trace:
        summary = cell.profile_stretch(win["requests"])
        result["trace"] = summary
        result["layer"] = {
            "trace": summary,
            "bounds_s": bounds_of(cell, summary, bench.sm_clock_hz, bench.n_sms),
            "window_flops": cell.window_flops(win["requests"]),
            "window_s": win["elapsed_s"]}
    cell.free_program()
    result["checks"] = cell.gaps()
    return result


CONTROL_DTYPE = "bfloat16"   # the program's own path below the cells' float32


def read_one(bench, seed: int, compute_dtype: str) -> CoarseSampling:
    """Request 0 of ``seed`` with the model built in ``compute_dtype``,
    finished, the program freed."""
    cell = CoarseSampling(bench.config, dict(bench.mix, compute_dtype=compute_dtype), seed,
                          bench.device)
    cell.done.append(cell.run_request(0, keep=True))
    cell.free_program()
    return cell


def readings(bench, seeds: List[int]) -> List[dict]:
    """The program's and the control's gaps on one request a seed, for the
    limits (``--readings``): no measured window. The control is the
    program with its bfloat16 path switched on, on the same request, and
    for the schedule, the update and the final draw, which that path keeps
    in float32, the reference's own in bfloat16."""
    rows = []
    for s in seeds:
        cell = read_one(bench, s, bench.mix["compute_dtype"])
        program, by_step = cell.gaps(), cell.eps_by_step
        with torch.no_grad():
            update = update_control_gaps(cell.weights, cell.model_cfg, cell.as_request(cell.done[0]))
        del cell
        low = read_one(bench, s, CONTROL_DTYPE)
        low_gaps = low.gaps()
        rows.append({"seed": s, "program": program, "control": dict(low_gaps, **update),
                     "control_path": {k: v for k, v in low_gaps.items() if k in update},
                     "eps_by_step": by_step, "control_eps_by_step": low.eps_by_step})
        print(rows[-1], file=sys.stderr, flush=True)
        del low
    return rows
