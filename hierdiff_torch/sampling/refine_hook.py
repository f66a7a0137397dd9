"""Beam-search refine perturbation: the check_tree hook.

Port of ``hierdiff_tpu/sampling/refine_hook.py`` (``RefineHook``), the
reference's ``Node2Vec.check_tree`` (models/model_refine.py:175-249): during
beam search, every assigned node of each candidate tree is re-scored by the
refine model (the node masked, a size-restricted softmax), and if swapping
one of the lowest-probability mispredicted nodes to the model's top choice
raises the tree's total log-probability (and passes the optional assembly
gate), the swap is committed and the tree skips its expansion this round.

The device work is one program per fleet chunk (``_fused_check``): it
expands each state to its masked-node variants, scores them with
``NodeRefine.check_logits``, applies the size-restricted log-softmax, picks
the K = max(1, int(nb * check_frac)) candidate swaps per state (a stable
sort of the per-node log-probabilities, the front-half, top != current and
``n_check`` filters), re-scores the K swap variants, and returns one packed
(rows, 1 + 4K) float32 tensor, copied to pinned host memory without a sync.
The host walks the slots in order (``collect_batch``). Every chunk of a
bucket is padded to one row count (``fleet_pad_rows``), so a row's result
does not depend on the fleet it came in, bit for bit.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from hierdiff_torch.data.collate import DEFAULT_BUCKETS, bucket_for
from hierdiff_torch.data.refine import MASK_TOKEN, size_support_indices
from hierdiff_torch.models.refine import NodeRefine
from hierdiff_torch.ops.masked import masked_log_softmax
from hierdiff_torch.sampling.beam import TreeState
from hierdiff_torch.sampling.lattice import HostCopy, _next_pow2


def _to_device(a: np.ndarray, device: torch.device) -> Tensor:
    """numpy -> ``device``; a CUDA copy goes through pinned memory and does
    not wait for the work already queued."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class RefineHook:
    def __init__(self, model: NodeRefine, vocab_sizes: np.ndarray, check_frac: float = 0.1,
                 can_assemble: Optional[Callable[[TreeState, int], bool]] = None,
                 buckets: Optional[Sequence[int]] = None):
        """vocab_sizes: heavy-atom count per vocab index
        (``data.assets.vocab_mol_sizes``). buckets: pad buckets of the
        fleets (None: ``DEFAULT_BUCKETS``); a fleet pads to the bucket of
        its largest active state. The model runs on its parameters'
        device."""
        if model.gated and not model.dynamic_depth:
            model = model.clone(dynamic_depth=True)   # exact under gated=True
        self.model = model
        self.device = next(model.parameters()).device
        self.vocab_sizes = np.asarray(vocab_sizes)
        self.check_frac = check_frac
        self.can_assemble = can_assemble
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        self._support_cache: Dict = {}
        self._size_table_cache: Optional[np.ndarray] = None
        self._device_tables: Optional[Tuple[Tensor, Tensor]] = None
        # score_s = dispatch_s + collect_s on the fused path: dispatch_s is
        # the host's pack-and-enqueue time (which includes the depth bounds'
        # reads), collect_s the wait for the packed copy, walk_s the host
        # walk over the slots (in the native search: the C++ step, which
        # walks, commits and expands). rounds, fleet_rows and lanes count
        # the native search's group rounds, the fleet rows they hand over
        # (fleet_rows / rounds: mean fleet) and its merged dispatches.
        self.stats = {"pack_s": 0.0, "pack_calls": 0, "score_s": 0.0,
                      "score_calls": 0, "score_rows": 0, "host_s": 0.0,
                      "dispatch_s": 0.0, "collect_s": 0.0, "walk_s": 0.0,
                      "rounds": 0, "fleet_rows": 0, "lanes": 0}

    # --- the size-restricted support ------------------------------------------

    def _support(self, size: int) -> np.ndarray:
        if size not in self._support_cache:
            self._support_cache[size] = np.asarray(
                size_support_indices(size, self.model.vocab_size), np.int64)
        return self._support_cache[size]

    def _support_mask(self, size: int) -> np.ndarray:
        key = ("mask", size)
        if key not in self._support_cache:
            m = np.zeros(self.model.vocab_size, bool)
            m[self._support(size)] = True
            self._support_cache[key] = m
        return self._support_cache[key]

    def _size_table(self) -> np.ndarray:
        """(max size + 1, V) support rows indexed by heavy-atom count: the
        device-side form of ``_support_mask``."""
        if self._size_table_cache is None:
            rows = [self._support_mask(s).astype(np.float32)
                    for s in range(int(self.vocab_sizes.max()) + 1)]
            self._size_table_cache = np.stack(rows)
        return self._size_table_cache

    def _tables(self) -> Tuple[Tensor, Tensor]:
        """The size table and the per-wid sizes on the model's device."""
        if self._device_tables is None:
            self._device_tables = (
                torch.from_numpy(self._size_table()).to(self.device),
                torch.from_numpy(self.vocab_sizes.astype(np.int64)).to(self.device))
        return self._device_tables

    # --- the fused check ----------------------------------------------------------

    def _score_grid(self, feats: Tensor, vocab_ids: Tensor, pos: Tensor, adj: Tensor,
                    nmask: Tensor, margins: bool):
        """Score every (row, masked node) variant of Q rows: (Q, N) the
        log-probability of each node's current wid and the top-1 proposal
        under the size-restricted log-softmax, and with ``margins`` the gap
        between the best and the runner-up log-probability."""
        q, n, _ = feats.shape
        model = self.model
        v = model.vocab_size
        table, vsizes = self._tables()
        idx = torch.arange(n, device=feats.device)
        eye = idx[:, None] == idx[None, :]
        # variant i of a row masks node i: features zeroed, vocab id MASK_TOKEN
        feats_e = feats[:, None] * (~eye).to(feats.dtype)[None, :, :, None]
        vocab_e = torch.where(eye[None], MASK_TOKEN, vocab_ids[:, None, :])
        cur = vocab_ids.clamp(0, v - 1)
        size = vsizes[cur]                                    # sizes of the current wids
        rs = lambda a: a.reshape((q * n,) + a.shape[2:])      # noqa: E731
        logits = model.check_logits(
            rs(feats_e), rs(vocab_e), rs(size[:, None].expand(q, n, n)),
            rs(pos[:, None].expand(q, n, n, 3)), rs(adj[:, None].expand(q, n, n, n)),
            rs(nmask[:, None].expand(q, n, n, 1)), idx.repeat(q), adj.sum(2).reshape(-1)
        ).reshape(q, n, v)                                    # val: each node's degree
        # the support of the current wid's size, the current wid forced in
        # (the reference appends it); one-hots by comparison with arange
        coh = cur[..., None] == torch.arange(v, device=feats.device)
        support = torch.maximum(table[size.clamp(0, table.shape[0] - 1)], coh.to(logits.dtype))
        lp = masked_log_softmax(logits, support)
        logp_cur = lp.gather(-1, cur[..., None])[..., 0]
        top = torch.argmax(lp, dim=-1)                        # the first maximum
        gap = None
        if margins:
            best2 = lp.topk(2, dim=-1).values
            gap = best2[..., 0] - best2[..., 1]
        return logp_cur, top, gap

    def _fused_check(self, feats: Tensor, wids: Tensor, pos: Tensor, adj: Tensor,
                     nmask: Tensor, nb: int, margins: bool = False) -> Tensor:
        """The device program of one fleet chunk at bucket nb: pass 1 scores
        every masked-node variant, the candidate selection runs on the
        device, and the K swap variants are re-scored over all their nodes.
        Returns (S, 1 + 4K) float32, columns [total, node_k * K, wid_k * K,
        valid * K, new_total * K]; with ``margins`` 2K + 1 more: each slot's
        gap to its neighbours in the sorted per-node log-probabilities, the
        gap between the best and the runner-up type at its node, and the
        row's largest |log-probability| (``tools/refine_check.py``)."""
        check_frac = self.check_frac
        K = max(1, int(nb * check_frac))
        s, n, _ = feats.shape
        with torch.no_grad():
            logp_cur, top, top_gap = self._score_grid(feats, wids, pos, adj, nmask, margins)
            # candidate selection: the host walk of the reference, on the device
            assigned = (wids >= 0) & (nmask[..., 0] > 0)                # (S, N)
            m = assigned.sum(1)
            n_check = torch.floor(m.to(torch.float32) * check_frac)
            keys = torch.where(assigned, logp_cur, torch.full_like(logp_cur, float("inf")))
            # jnp.argsort is stable, and the +inf keys of unassigned nodes tie
            sorted_keys, order = torch.sort(keys, dim=1, stable=True)
            rank = assigned.long().cumsum(1) - 1
            node_k = order[:, :K]                                       # (S, K)
            i_k = rank.gather(1, node_k)
            cur_k = wids.gather(1, node_k)
            top_k = top.gather(1, node_k)
            valid = ((torch.arange(K, device=feats.device)[None, :] < n_check[:, None])
                     & (i_k.to(torch.float32) < 0.5 * m[:, None].to(torch.float32))
                     & (top_k != cur_k) & assigned.gather(1, node_k))   # (S, K)
            # swap variants: node_k -> top_k where valid
            sel = (node_k[..., None] == torch.arange(n, device=feats.device)) & valid[..., None]
            wids_k = torch.where(sel, top_k[..., None], wids[:, None, :])   # (S, K, N)
            bc = lambda a: a[:, None].expand((s, K) + a.shape[1:]).reshape(  # noqa: E731
                (s * K,) + a.shape[1:])
            new_logp, _, _ = self._score_grid(bc(feats), wids_k.reshape(s * K, n), bc(pos),
                                              bc(adj), bc(nmask), False)
            amask = assigned.to(logp_cur.dtype)
            total = (logp_cur * amask).sum(1)
            new_total = (new_logp.reshape(s, K, n) * amask[:, None, :]).sum(2)
            cols = [total[:, None], node_k.to(total.dtype), top_k.to(total.dtype),
                    valid.to(total.dtype), new_total]
            if margins:
                inf = torch.full((s, 1), float("inf"), dtype=total.dtype, device=total.device)
                steps = torch.nan_to_num(sorted_keys[:, 1:] - sorted_keys[:, :-1],
                                         nan=float("inf"),
                                         posinf=float("inf"))
                order_gap = torch.minimum(torch.cat([inf, steps], 1), torch.cat([steps, inf], 1))
                scale = torch.where(assigned, logp_cur.abs(), torch.zeros_like(logp_cur))
                cols += [order_gap[:, :K], top_gap.gather(1, node_k),
                         scale.max(1).values[:, None]]
            return torch.cat(cols, dim=1)

    def _pack_states(self, states: Sequence[TreeState], nb: int, sp: int):
        """Per-state base arrays on the device: feats, pos, adj (diagonal
        cleared) and node mask, zero-padded to (sp, nb)."""
        t0 = time.perf_counter()
        f = states[0].feats.shape[1]
        feats = np.zeros((sp, nb, f), np.float32)
        pos = np.zeros((sp, nb, 3), np.float32)
        adj = np.zeros((sp, nb, nb), np.float32)
        nmask = np.zeros((sp, nb, 1), np.float32)
        for i, s in enumerate(states):
            n = s.n
            feats[i, :n] = s.feats
            pos[i, :n] = s.pos
            a = s.adj.copy()
            np.fill_diagonal(a, 0)
            adj[i, :n, :n] = a
            nmask[i, :n] = 1.0
        out = tuple(_to_device(a, self.device) for a in (feats, pos, adj, nmask))
        self.stats["pack_s"] += time.perf_counter() - t0
        self.stats["pack_calls"] += 1
        return out

    def _dispatch_fused(self, base, wids_rows: Sequence[np.ndarray], nb: int, sp: int,
                        margins: bool = False):
        """Enqueue one fused check and the copy of its packed result to
        pinned host memory; do not wait for either. Returns the token
        ``_collect_fused`` takes."""
        t0 = time.perf_counter()
        feats, pos, adj, nmask = base
        wids = np.zeros((sp, nb), np.int64)
        for i, w in enumerate(wids_rows):
            wids[i, :len(w)] = w
            wids[i, len(w):] = -1     # padding nodes read as unassigned
        token = HostCopy((self._fused_check(feats, _to_device(wids, self.device), pos, adj,
                                            nmask, nb, margins),))
        dt = time.perf_counter() - t0
        self.stats["score_s"] += dt
        self.stats["dispatch_s"] += dt
        self.stats["score_calls"] += 1
        self.stats["score_rows"] += sp
        return token

    @staticmethod
    def wait_packed(token: HostCopy, n_rows: int) -> np.ndarray:
        """Wait for one packed copy (the token of ``_dispatch_fused``): its
        first n_rows rows, (n_rows, 1 + 4K) float32."""
        return token.wait()[0][:n_rows]

    def _collect_fused(self, token, n_rows: int, K: int):
        """Wait for one packed copy and unpack it to numpy (total, node_k,
        wid_k, valid, new_total), trimmed to n_rows."""
        t0 = time.perf_counter()
        packed = self.wait_packed(token, n_rows)
        total = packed[:, 0]
        node_k = packed[:, 1: 1 + K].astype(np.int64)
        wid_k = packed[:, 1 + K: 1 + 2 * K].astype(np.int64)
        valid = packed[:, 1 + 2 * K: 1 + 3 * K] > 0.5
        new_total = packed[:, 1 + 3 * K: 1 + 4 * K]
        dt = time.perf_counter() - t0
        self.stats["score_s"] += dt
        self.stats["collect_s"] += dt
        return total, node_k, wid_k, valid, new_total

    # --- per-job scoring (finalize) -------------------------------------------------

    def _score_nodes(self, jobs: List[Tuple[TreeState, np.ndarray, int]]) -> np.ndarray:
        """Each job = (state, wids, masked node); one model call over all of
        them. Returns logits (len(jobs), V). The job count is padded to a
        power of two, as in the JAX package, so the batch shapes stay few."""
        t0 = time.perf_counter()
        nb = bucket_for(max(j[0].n for j in jobs), self.buckets)
        k = len(jobs)
        kp = _next_pow2(k)
        f = jobs[0][0].feats.shape[1]
        feats = np.zeros((kp, nb, f), np.float32)
        vocab = np.zeros((kp, nb), np.int64)
        size = np.zeros((kp, nb), np.int64)
        pos = np.zeros((kp, nb, 3), np.float32)
        adj = np.zeros((kp, nb, nb), np.float32)
        nmask = np.zeros((kp, nb, 1), np.float32)
        pad_idx = np.zeros((kp,), np.int64)
        val = np.zeros((kp,), np.float32)
        for i, (s, wids, node) in enumerate(jobs):
            n = s.n
            feats[i, :n] = s.feats
            feats[i, node] = 0.0
            vocab[i, :n] = wids
            vocab[i, node] = MASK_TOKEN
            size[i, :n] = self.vocab_sizes[np.clip(wids, 0, len(self.vocab_sizes) - 1)]
            a = s.adj.copy()
            np.fill_diagonal(a, 0)
            adj[i, :n, :n] = a
            pos[i, :n] = s.pos
            nmask[i, :n] = 1.0
            pad_idx[i] = node
            val[i] = a[node].sum()
        logits = self.model.check_logits(*(_to_device(a, self.device) for a in (
            feats, vocab, size, pos, adj, nmask, pad_idx, val)))
        out = logits.cpu().numpy()[:k]
        self.stats["score_s"] += time.perf_counter() - t0
        self.stats["score_calls"] += 1
        self.stats["score_rows"] += kp
        return out

    def _logps_from_logits(self, wids: np.ndarray, nodes: Sequence[int], logits: np.ndarray):
        """Size-restricted logp of the current wid and the top-1 proposal per
        node, for logits (len(nodes), V) already scored for (wids, node)."""
        nodes = np.asarray(list(nodes), np.int64)
        k = len(nodes)
        if k == 0:
            return np.zeros(0), np.zeros(0, np.int64)
        cur = np.asarray(wids)[nodes].astype(np.int64)
        sizes = self.vocab_sizes[np.clip(cur, 0, len(self.vocab_sizes) - 1)]
        mask = np.stack([self._support_mask(int(s)) for s in sizes])
        mask[np.arange(k), cur] = True
        ls = np.where(mask, logits[:k], -np.inf)
        mx = ls.max(axis=1, keepdims=True)
        lp = ls - (mx + np.log(np.exp(ls - mx).sum(axis=1, keepdims=True)))
        logps = lp[np.arange(k), cur]
        top = np.argmax(lp, axis=1).astype(np.int64)
        return logps, top

    def _node_logps(self, state: TreeState, wids: np.ndarray, nodes: np.ndarray):
        jobs = [(state, wids, int(n)) for n in nodes]
        return self._logps_from_logits(wids, nodes, self._score_nodes(jobs))

    # --- the fleet check --------------------------------------------------------------

    def check_state(self, state: TreeState) -> Tuple[TreeState, float, bool]:
        """(reference: model_refine.py:175-249)"""
        return self.check_batch([state])[0]

    def fleet_chunk_rows(self, nb: int) -> int:
        """Most fleet rows per fused check at bucket nb: bounds one program
        to (1 + K) * rows * nb masked-node variants, and to 64 rows."""
        K = max(1, int(nb * self.check_frac))
        return max(1, min(8192 // (nb * (1 + K)), 64))

    def fleet_pad_rows(self, nb: int) -> int:
        """The one padded row count of every fused check at bucket nb. Rows
        are independent trees, and with one shape per bucket the kernels
        (cuBLAS picks its algorithm by shape) are the same for every chunk,
        so a row's result does not depend on its fleet, bit for bit; the
        pipelined, merged and sequential searches rest on that."""
        return _next_pow2(self.fleet_chunk_rows(nb))

    def dispatch_batch(self, states: List[TreeState]):
        """First half of ``check_batch``: pack and enqueue every fleet chunk
        without waiting. Returns a token for ``collect_batch``."""
        act = [si for si, s in enumerate(states)
               if np.sum(s.wids >= 0) * self.check_frac > 1]
        if not act:
            return (None, [])
        nb = bucket_for(max(states[si].n for si in act), self.buckets)
        K = max(1, int(nb * self.check_frac))
        max_states = self.fleet_chunk_rows(nb)
        sp = self.fleet_pad_rows(nb)   # one shape per bucket
        pending = []
        for c0 in range(0, len(act), max_states):
            chunk = act[c0: c0 + max_states]
            base = self._pack_states([states[si] for si in chunk], nb, sp)
            token = self._dispatch_fused(base, [states[si].wids for si in chunk], nb, sp)
            pending.append((chunk, token))
        return (K, pending)

    def dispatch_arrays(self, nb: int, feats: np.ndarray, pos: np.ndarray, adj: np.ndarray,
                        nmask: np.ndarray, wids: np.ndarray) -> List[tuple]:
        """Chunk, pad and enqueue a fleet that is already packed: ``rows``
        states at bucket nb as arrays (rows, nb, ...), from the native
        search. The policy of ``dispatch_batch``: at most
        ``fleet_chunk_rows`` rows per check, every chunk padded to
        ``fleet_pad_rows``, padding rows unassigned, the same
        ``_dispatch_fused`` token. Returns [(rows in chunk, token), ...];
        ``wait_packed(token, rows)`` collects each."""
        rows = len(feats)
        max_states = self.fleet_chunk_rows(nb)
        sp = self.fleet_pad_rows(nb)   # one shape per bucket
        pending = []
        for c0 in range(0, rows, max_states):
            c1 = min(rows, c0 + max_states)
            cnt = c1 - c0
            t0 = time.perf_counter()
            padded = []
            for a in (feats, pos, adj, nmask):
                p = np.zeros((sp,) + a.shape[1:], np.float32)
                p[:cnt] = a[c0:c1]
                padded.append(_to_device(p, self.device))
            self.stats["pack_s"] += time.perf_counter() - t0
            self.stats["pack_calls"] += 1
            pending.append((cnt, self._dispatch_fused(tuple(padded), list(wids[c0:c1]), nb, sp)))
        return pending

    def collect_batch(self, token, states: List[TreeState]) -> List[Tuple[TreeState, float, bool]]:
        """Second half of ``check_batch``: unpack each chunk's packed copy,
        then walk each state's candidate slots in order and commit the first
        that raises the total (and passes the assembly gate), as the
        reference's sequential loop does (model_refine.py:175-249)."""
        K, pending = token
        results: List[Tuple[TreeState, float, bool]] = [(s, 0.0, False) for s in states]
        for chunk, dev in pending:
            total_m, node_m, wid_m, valid_m, new_total_m = self._collect_fused(
                dev, len(chunk), K)
            t_walk = time.perf_counter()
            for row, si in enumerate(chunk):
                s = states[si]
                total = total_m[row]
                for k in range(K):
                    if not valid_m[row, k]:
                        continue
                    new_total = new_total_m[row, k]
                    if new_total <= total:
                        continue
                    node = int(node_m[row, k])
                    new_wids = s.wids.copy()
                    new_wids[node] = int(wid_m[row, k])
                    perturbed = s.clone()
                    perturbed.wids = new_wids
                    if (self.can_assemble is not None
                            and not self.can_assemble(perturbed, node)):
                        continue
                    results[si] = (perturbed, float(total - new_total), True)
                    break
            self.stats["walk_s"] += time.perf_counter() - t_walk
        return results

    def check_batch(self, states: List[TreeState]) -> List[Tuple[TreeState, float, bool]]:
        """check_tree over a fleet of beam candidates: one fused check per
        fleet chunk, every chunk enqueued before any is collected."""
        return self.collect_batch(self.dispatch_batch(states), states)

    def finalize(self, state: TreeState, check_num: int = 10) -> Optional[TreeState]:
        """End-of-search repair: fix non-assemblable nodes by swapping to
        higher-probability same-size fragments; give up when more than 20%
        of the nodes are broken or any stays unfixable.
        (reference: model_refine.py:252-299 check_final_tree)

        Needs a ``can_assemble(state, node)`` gate; without one the tree is
        returned unchanged."""
        if self.can_assemble is None:
            return state
        n = state.n
        broken = [i for i in range(n) if not self.can_assemble(state, i)]
        if not broken:
            return state
        if len(broken) > 0.2 * n:
            return None
        wids = state.wids.copy()
        assigned = np.arange(n)
        logps, _ = self._node_logps(state, wids, assigned)
        total = logps.sum()
        fixed = 0
        for node in broken:
            jobs = [(state, wids, int(node))]
            logits = self._score_nodes(jobs)[0]
            support = self._support(int(self.vocab_sizes[int(wids[node])]))
            order = support[np.argsort(-logits[support])][:check_num]
            for wid in order:
                if wid == wids[node]:
                    continue
                new_wids = wids.copy()
                new_wids[node] = wid
                cand = state.clone()
                cand.wids = new_wids
                if not self.can_assemble(cand, node):
                    continue
                new_logps, _ = self._node_logps(state, new_wids, assigned)
                if new_logps.sum() > total:
                    wids = new_wids
                    total = new_logps.sum()
                    fixed += 1
                    break
        if fixed == len(broken):
            out = state.clone()
            out.wids = wids
            return out
        return None

    def __call__(self, states: List[TreeState]) -> List[TreeState]:
        """Round-based sampler hook: perturb in place; perturbed trees keep
        their improved state and still expand this round."""
        out = []
        for s in states:
            new_s, dlogp, changed = self.check_state(s)
            if changed:
                new_s.logp += dlogp
            out.append(new_s)
        return out
