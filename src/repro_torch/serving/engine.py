"""Batched serving engine: prefill-by-decode + greedy generation loop.

Small-scale engine over the per-layer decode functions of
models/transformer.py (eager PyTorch, one call a layer).  Two KV tiers:

* ``kv_offload=False``: dense per-sequence caches (reference path).
* ``kv_offload=True``: the paged capacity tier.  K/V lives in a physical
  block pool of exactly ``budget_blocks`` slots, addressed through
  per-(layer, sequence) block tables.  Evicting a cold block GPULZ-
  compresses it into ``KVBlockStore`` (one batched ``evict_many`` dispatch
  per round, straight from the pool on the device) AND frees its physical
  slot; touching an evicted block restores it through batched
  ``decompress_many`` into a freshly allocated slot, with a prefetch queue
  restoring predicted-hot blocks (the next access group in the layer-major
  sequence) ahead of demand.

The tier is *layer-streaming*: each decode step runs the layers one at a
time, so only the current layer's block working set must be resident and
the budget can sit well below the all-layers working set while staying
exact.  Both tiers run the same per-layer functions, whose paged and dense
forms round alike, so generated tokens are bit-identical between them.

With ``async_prefetch=True`` the prefetch restore runs on a background
thread: ``_drain_prefetch`` allocates target slots on the main thread,
hands the ``restore_many`` dispatch to the worker, and the next access
group's ``_ensure_resident`` is the barrier that joins the worker and
installs the restored blocks into the pool BEFORE any layer reads them, so
the decompression overlaps the previous layer's step while paged-vs-dense
stays bit-identical (the pool contents at every layer call are exactly the
sync path's).  The kernels' build is guarded by a lock
(``kernels/_build.py``), so a worker's first launch may build them.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.models import attention, common, ssm, transformer
from repro_torch.serving.kvcache import KVBlockStore, PagedKVTracker
from repro_torch.serving.paging import BlockPoolAllocator, PrefetchQueue


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray      # (B, T_out)
    steps: int


class ServingEngine:
    """Greedy generation over a port model (``params``, a ``Transformer``)
    on ``device`` (``None``: ``cuda``, raising without a card), which must
    be the device the model lies on."""

    def __init__(self, cfg, params, max_len: int = 512, kv_compress=False,
                 kv_offload: bool = False, block_tokens: int = 256, budget_blocks: int = 1024,
                 kv_decoder: str = "auto", kv_backend: str = "auto", kv_mesh=None,
                 kv_batch_axis=None, kv_prefetch: bool = True, prefetch_lookahead: int = 1,
                 async_prefetch: bool = False, device=None):
        self.device = common.resolve_device(device)
        held = next(params.parameters()).device
        if held.type != self.device.type:
            raise ValueError(f"the model lies on {held}, the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.kv_offload = kv_offload
        self.block_tokens = block_tokens
        self.budget_blocks = budget_blocks
        self.kv_prefetch = kv_prefetch
        self.prefetch_lookahead = prefetch_lookahead
        # async_prefetch: run the prefetch restore (restore_many + host
        # reshape) on a background worker; the next access group's
        # _ensure_resident is the barrier that installs the result before
        # any layer reads it
        self.async_prefetch = async_prefetch
        self._pf_pending = None
        # kv_backend / kv_decoder: registry keys of the cold-block eviction
        # and restore dispatches ("auto": the one-launch fused-mono pair on
        # a card).  kv_mesh shards each round's batch over a sequence of
        # devices: KVBlockStore maps "auto" onto the "sharded" pair.
        self.kv_store = KVBlockStore(compress=kv_compress, backend=kv_backend, decoder=kv_decoder,
                                     mesh=kv_mesh, batch_axis=kv_batch_axis, device=self.device)
        self.tracker = PagedKVTracker(block_tokens=block_tokens, budget_blocks=budget_blocks)
        if kv_offload:
            if cfg.mixer not in ("attention", "hybrid"):
                raise NotImplementedError(
                    f"paged KV tier supports attention/hybrid mixers, not {cfg.mixer!r}")
            if cfg.kv_quant:
                raise NotImplementedError("paged KV tier does not support kv_quant")
            if max_len % block_tokens:
                raise ValueError(
                    f"max_len={max_len} not a multiple of block_tokens={block_tokens}")
        self._is_global = [transformer.layer_is_global(cfg, i) for i in range(cfg.num_layers)]
        self._gen_id = 0
        self._stats = {"demand_restores": 0, "async_prefetch_batches": 0}

    # ------------------------------------------------- paged-tier host side

    def _needed_blocks(self, layer, pos):
        """Logical block ids layer ``layer`` reads/writes at step ``pos``."""
        bt = self.block_tokens
        hi = pos // bt
        lo = 0
        w = self.cfg.sliding_window
        if w and not self._is_global[layer]:
            lo = max(0, pos - w + 1) // bt
        return list(range(lo, hi + 1))

    def _store_key(self, key):
        # generation-counter namespace: keys from a previous generate()
        # can never alias this one's
        return (self._gen_id,) + key

    def _begin_paged(self, batch, horizon):
        cfg = self.cfg
        ell = cfg.num_layers
        self._join_prefetch()  # a stale worker must never outlive its pool
        self._batch = batch
        self._horizon = horizon
        n_logical = -(-horizon // self.block_tokens)
        peak = batch * max(len(self._needed_blocks(i, horizon - 1)) for i in range(ell))
        if self.budget_blocks < peak:
            raise ValueError(
                f"budget_blocks={self.budget_blocks} below the peak "
                f"per-layer working set ({peak} blocks for batch={batch}, "
                f"{horizon} positions): exact paged decode impossible"
            )
        dt = common.dtype_of(cfg)
        self._pool = attention.init_paged_kv_pool(cfg, self.budget_blocks, self.block_tokens, dt,
                                                  self.device)
        self._tables = np.full((ell, batch, max(n_logical, 1)), -1, np.int32)
        self._extra = [{"ssm": ssm.init_ssm_cache(cfg, batch, dt, self.device)}
                       if cfg.mixer == "hybrid" else {} for _ in range(ell)]
        self._alloc = BlockPoolAllocator(self.budget_blocks)
        self._slot = {}          # (layer, sid, blk) -> physical slot
        self._stored = set()     # keys currently compressed in kv_store
        self._prefetched = set()  # restored ahead of demand, not yet touched
        self._retired_upto = {}  # (layer, sid) -> first non-dead SWA block
        self._ever = set()       # every key ever materialized (working set)
        self._pq = PrefetchQueue(lookahead=self.prefetch_lookahead)
        self.tracker = PagedKVTracker(self.block_tokens, self.budget_blocks)
        # static block geometry, captured once so the async worker never
        # reads the pool
        bt = self.block_tokens
        kvh, dh = self._pool["k"].shape[2], self._pool["k"].shape[3]
        self._blk_shape = (bt, kvh, dh)
        self._blk_half = bt * kvh * dh * self._pool["k"].element_size()
        self._gen_id += 1
        for k in self.kv_store.keys():  # drop stale-generation blocks
            if isinstance(k, tuple) and len(k) == 4 and k[0] != self._gen_id:
                self.kv_store.discard(k)
        self._stats = {"demand_restores": 0, "async_prefetch_batches": 0}

    def _evict_blocks(self, victims):
        """Compress + free a batch of resident blocks (one dispatch).  Each
        blob is one block's K bytes, then its V bytes, taken from the pool
        on the device."""
        if not victims:
            return
        slots = torch.tensor([self._slot[k] for k in victims], device=self.device)
        n = len(victims)
        blobs = torch.cat([self._pool["k"][slots].view(torch.uint8).reshape(n, -1),
                           self._pool["v"][slots].view(torch.uint8).reshape(n, -1)], 1)
        self.kv_store.evict_many(
            [(self._store_key(key), blobs[j]) for j, key in enumerate(victims)])
        for key in victims:
            layer, sid, blk = key
            self._tables[layer, sid, blk] = -1
            self._alloc.free(self._slot.pop(key))
            self._stored.add(key)
            self.tracker.drop(key)
            self._prefetched.discard(key)

    def _stack_blobs(self, blobs):
        """Host-side split of restored blobs into (n, half) K and V bytes.
        Reads only static geometry, so it is safe on the async prefetch
        worker while the main thread owns the pool."""
        half = self._blk_half
        flat = np.stack([np.asarray(b).reshape(-1) for b in blobs])
        return flat[:, :half], flat[:, half:]

    def _install_blocks(self, keys, slots, kstack, vstack, *, prefetch):
        """Copy restored blocks into their (pre-allocated) slots and publish
        the mapping.  Main thread only."""
        idx = torch.tensor(slots, device=self.device)
        for name, stack in (("k", kstack), ("v", vstack)):
            pool = self._pool[name]
            rows = torch.from_numpy(np.ascontiguousarray(stack)).to(self.device)
            pool[idx] = rows.view(pool.dtype).reshape(len(slots), *self._blk_shape)
        for key, slot in zip(keys, slots):
            layer, sid, blk = key
            self._tables[layer, sid, blk] = slot
            self._slot[key] = slot
            self._stored.discard(key)
            self.tracker.touch_block(key)
            if prefetch:
                self._prefetched.add(key)
        if prefetch:
            self._pq.issued += len(keys)

    def _restore_blocks(self, keys, *, prefetch=False):
        """Decompress stored blocks into fresh slots (one dispatch round,
        one pool copy per direction)."""
        if not keys:
            return
        slots = [self._alloc.alloc() for _ in keys]
        blobs = self.kv_store.restore_many([self._store_key(k) for k in keys])
        kstack, vstack = self._stack_blobs(blobs)
        self._install_blocks(keys, slots, kstack, vstack, prefetch=prefetch)

    def _join_prefetch(self):
        """Barrier for the async prefetch worker: wait for the in-flight
        restore, install its blocks, re-raise its error.  Called before ANY
        pool/table/store mutation or read can observe prefetch state, so
        async-on and sync-on see identical pool contents at every layer
        call."""
        pending, self._pf_pending = self._pf_pending, None
        if pending is None:
            return
        th, box, keys, slots = pending
        th.join()
        if "err" in box:
            raise box["err"]
        kstack, vstack = box["kv"]
        self._install_blocks(keys, slots, kstack, vstack, prefetch=True)

    def _retire_dead_blocks(self, layer, lo):
        """Free SWA blocks that slid wholly out of the attention window:
        nothing will ever read them again, resident or stored."""
        for sid in range(self._batch):
            start = self._retired_upto.get((layer, sid), 0)
            for blk in range(start, lo):
                key = (layer, sid, blk)
                if key in self._slot:
                    self._tables[layer, sid, blk] = -1
                    self._alloc.free(self._slot.pop(key))
                    self.tracker.drop(key)
                self._stored.discard(key)
                self._prefetched.discard(key)
                self.kv_store.discard(self._store_key(key))
            self._retired_upto[(layer, sid)] = max(start, lo)

    def _ensure_resident(self, layer, pos):
        """Make every block layer ``layer`` touches at ``pos`` resident:
        evict LRU non-needed blocks for room, restore stored blocks in one
        batched dispatch, allocate zero-history slots for new blocks."""
        self._join_prefetch()  # barrier: async restores land before any use
        needed = self._needed_blocks(layer, pos)
        if needed[0] > 0:
            self._retire_dead_blocks(layer, needed[0])
        nkeys = [(layer, sid, blk) for sid in range(self._batch) for blk in needed]
        for k in nkeys:
            if k in self._prefetched:  # first demand touch since prefetch
                self._prefetched.discard(k)
                self._pq.hits += 1
        demand = [k for k in nkeys if k in self._stored]
        new = [k for k in nkeys if k not in self._stored and k not in self._slot]
        deficit = len(demand) + len(new) - self._alloc.free_blocks
        if deficit > 0:
            victims = self.tracker.candidates(deficit, protected=nkeys)
            if len(victims) < deficit:
                raise RuntimeError(
                    f"budget_blocks={self.budget_blocks} cannot hold layer "
                    f"{layer}'s working set at pos={pos} ({len(nkeys)} blocks needed)")
            self._evict_blocks(victims)
        if demand:
            self._restore_blocks(demand)
            self._stats["demand_restores"] += len(demand)
        for k in new:
            slot = self._alloc.alloc()
            self._slot[k] = slot
            layer_, sid, blk = k
            self._tables[layer_, sid, blk] = slot
        for k in nkeys:
            self.tracker.touch_block(k)
        self._ever.update(nkeys)

    def _next_groups(self, layer, pos):
        """The next ``prefetch_lookahead`` (layer, pos) access groups after
        ``(layer, pos)`` in layer-major order: crossing a step boundary
        this is the next-block-in-sequence prediction."""
        groups = []
        li, p = layer, pos
        for _ in range(self.prefetch_lookahead):
            li += 1
            if li >= self.cfg.num_layers:
                li, p = 0, p + 1
                if p >= self._horizon:
                    break
            groups.append((li, p))
        return groups

    def _push_prefetch(self, layer, pos):
        for li, p in self._next_groups(layer, pos):
            for sid in range(self._batch):
                for blk in self._needed_blocks(li, p):
                    key = (li, sid, blk)
                    if key in self._stored:
                        self._pq.push(key)

    def _drain_prefetch(self, layer, pos):
        """Restore queued predicted-hot blocks.  Best-effort: evicts only
        LRU blocks outside the imminent working set, never raises: a full
        pool just drops the remainder of the queue for this round.

        Async mode: slots are allocated and victims evicted here (the main
        thread owns allocator and pool), then the restore runs on a
        background worker so it overlaps the next layer's step;
        ``_join_prefetch`` installs the result at the next access group's
        barrier."""
        self._join_prefetch()
        targets = [k for k in self._pq.pop_all() if k in self._stored]
        if not targets:
            return
        protected = set(targets)
        for li, p in self._next_groups(layer, pos):
            protected.update((li, sid, blk) for sid in range(self._batch)
                             for blk in self._needed_blocks(li, p))
        deficit = len(targets) - self._alloc.free_blocks
        if deficit > 0:
            self._evict_blocks(self.tracker.candidates(deficit, protected=protected))
        take = targets[: self._alloc.free_blocks]
        if not take:
            return
        if not self.async_prefetch:
            self._restore_blocks(take, prefetch=True)
            return
        slots = [self._alloc.alloc() for _ in take]
        store_keys = [self._store_key(k) for k in take]
        box = {}

        def work():
            try:
                blobs = self.kv_store.restore_many(store_keys)
                box["kv"] = self._stack_blobs(blobs)
            except BaseException as exc:  # surfaced at the join barrier
                box["err"] = exc

        th = threading.Thread(target=work, name="kv-prefetch", daemon=True)
        self._pf_pending = (th, box, take, slots)
        self._stats["async_prefetch_batches"] += 1
        th.start()

    def paging_stats(self) -> dict:
        """Capacity-tier counters for the last/current generate() call."""
        s = dict(self._stats)
        pq = getattr(self, "_pq", None)
        alloc = getattr(self, "_alloc", None)
        s["prefetch_issued"] = pq.issued if pq is not None else 0
        s["prefetch_hits"] = pq.hits if pq is not None else 0
        s["budget_blocks"] = self.budget_blocks
        s["async_prefetch"] = self.async_prefetch
        s["high_water"] = alloc.high_water if alloc is not None else 0
        s["resident_blocks"] = alloc.allocated if alloc is not None else 0
        s["working_set_blocks"] = len(getattr(self, "_ever", ()))
        return s

    # ------------------------------------------------------------ generate

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32,
                 eos_id: int = -1) -> GenerationResult:
        """prompts: (B, Tp) int32.  Greedy decode."""
        cfg, params, dev = self.cfg, self.params, self.device
        prompts = np.asarray(prompts, np.int32)
        b, tp = prompts.shape
        horizon = min(tp + max_new_tokens - 1, self.max_len - 1)
        paged = self.kv_offload
        if paged:
            self._begin_paged(b, horizon)
            caches = None
        else:
            caches = transformer.init_cache(cfg, b, self.max_len, device=dev)
        toks = torch.from_numpy(prompts[:, 0].copy()).to(dev)
        outs = [prompts[:, 0]]
        n_steps = 0
        for pos in range(horizon):
            x = transformer.decode_embed(params, cfg, toks)
            for i, lp in enumerate(params.layers):
                if paged:
                    self._ensure_resident(i, pos)
                    table = torch.from_numpy(self._tables[i].copy()).to(dev)
                    x, _, _ = transformer.decode_layer_paged(
                        lp, cfg, self._pool, table, self._extra[i], x, pos, self._is_global[i])
                    assert self._alloc.allocated <= self.budget_blocks
                    if self.kv_prefetch:
                        self._push_prefetch(i, pos)
                        self._drain_prefetch(i, pos)
                else:
                    x, _ = transformer.decode_layer(lp, cfg, caches[i], x, pos,
                                                    self._is_global[i])
            logits = transformer.decode_finish(params, cfg, x)
            n_steps += 1
            if pos + 1 < tp:
                toks = torch.from_numpy(prompts[:, pos + 1].copy()).to(dev)  # teacher-forced
            else:
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
            outs.append(toks.cpu().numpy())
            if eos_id >= 0 and bool(torch.all(toks == eos_id)):
                break
        if paged:
            self._join_prefetch()  # no worker outlives the generate call
        return GenerationResult(tokens=np.stack(outs, axis=1), steps=n_steps)
