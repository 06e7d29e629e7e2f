"""Fault-tolerant checkpointing with GPULZ-compressed shards (the PyTorch port).

Layout:  <dir>/step_<N>/
             manifest.json       tree structure, shapes, dtypes, per-leaf CRC
             COMMIT              commit marker, written LAST before publish
             <leaf-id>.gplz      GPULZ container  (or .raw if compression off)
         <dir>/step_<N>.tmp...   staging dir, atomically renamed on success

The layout, the file names, the manifest's text and every blob are the
reference package's (``repro/checkpoint/manager.py``) byte for byte, so a
step written by either package restores in the other.  That rests on three
things done as the reference does them:

  * leaf names and order: a tree is flattened in JAX's order (dict keys
    sorted, list and tuple entries as ``[i]``, ``None`` no leaf), names
    joined with ``/``; the port's train state (``{"params": Transformer,
    "opt": {"m", "v"}, "step"}``) is flattened through
    ``models/convert.train_state_tree``, i.e. in the reference's
    ``init_train_state`` layout with the layers stacked;
  * the groups: one ``lzss.compress_many`` per (symbol size, chunk-count
    bucket, lossy) group, leaves in tree order, so each container is padded
    to the same chunk count as the reference's;
  * dtypes by numpy's names: a bf16 leaf is written as ``"bfloat16"`` and
    restored from its 16-bit pattern (no ``ml_dtypes`` needed).

Fault-tolerance properties (the reference's):
  * atomic publish (tmp dir + rename) — a crash mid-save never corrupts the
    latest checkpoint;
  * commit-marker discipline: blobs -> manifest -> ``COMMIT`` -> rename.
    ``steps()`` lists only marker-bearing dirs, so a half-written step is
    never restorable, never counts toward retention, and never blocks GC of
    older complete steps — ``_gc`` removes such debris once no writer owns
    it;
  * ``async_writes=True`` hands every byte to the double-buffered
    background writer (``runtime/async_io.AsyncBlobWriter``): ``save``
    queues each group's blobs as soon as its dispatch returns and returns
    before the step is durable.  A background failure surfaces on the NEXT
    ``save``/``wait_until_finished`` as an ``AsyncWriteError`` naming the
    step and path; an in-flight step is never GC'd.  The writer's thread
    gets host bytes only: every device copy has finished before a blob is
    queued;
  * every write goes through the ``runtime/fault.HostFS`` seam under a
    ``RetryPolicy``; restore reads blobs directly (the crash harness
    injects faults into writes only);
  * every leaf CRC-checked on restore (lossy leaves: the stored container);
    a damaged step is skipped and the previous valid step restored
    (``restore_latest``);
  * mesh-agnostic: leaves are stored whole; ``lz_mesh`` splits each group's
    dispatch over a sequence of devices (the ``"sharded"`` pair) with
    byte-identical blobs, and ``runtime/elastic.py`` re-points it at the
    restore-side mesh.

Bytes already on the card stay there: a tensor leaf on the manager's device
goes to the compressor as it lies (``lzss.compress_many`` takes tensors);
the one host copy of its raw bytes is the one its CRC needs.  Restored
leaves come back as tensors on the device ``shardings`` names (a device, an
object with a ``.device`` such as ``sharding/rules.Placement``, or a tree of
them), on the CPU when it is ``None``; they go there after their CRC.  The
codec runs on ``device`` (``None``: ``cuda``, raising without a card).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib

import numpy as np
import torch

from repro_torch.core import lzss
from repro_torch.models import convert
from repro_torch.runtime.async_io import AsyncBlobWriter, RetryPolicy
from repro_torch.runtime.fault import HostFS

COMMIT_MARKER = "COMMIT"


def _symbol_size(itemsize: int) -> int:
    return {4: 4, 2: 2, 1: 1}.get(itemsize, 4)


# ------------------------------------------------------------------ trees


def _flatten(tree, path=()):
    """``(path, leaf)`` pairs in JAX's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (f"[{i}]",))
    else:
        yield path, tree


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _lazy_stack(tensors):
    """A stacked layer leaf, made when the save needs its bytes."""
    return lambda: torch.stack(tensors)


def _leaf_paths(tree):
    """(names, leaves, rebuild): a port train state in the reference's
    layout, its stacked leaves as functions that make them; ``rebuild``
    maps a list of restored leaves back to ``tree``'s kind."""
    train = convert.is_train_state(tree)
    ref = convert.train_state_tree(tree, stack=_lazy_stack) if train else tree
    flat = list(_flatten(ref))
    names = ["/".join(path) for path, _ in flat]

    def rebuild(leaves, device):
        out = _unflatten(ref, iter(leaves))
        if train:
            return convert.train_state_from_numpy(out, tree["params"].cfg, device)
        return out

    return names, [leaf for _, leaf in flat], rebuild


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name of a tensor's dtype (``"bfloat16"`` for bf16)."""
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _leaf_array(leaf):
    """A leaf as a tensor or a numpy array (a lazy leaf made)."""
    if callable(leaf):
        leaf = leaf()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous()
    arr = np.asarray(leaf)
    return arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)


def _host_bytes(arr) -> np.ndarray:
    """The leaf's bytes on the host as a flat uint8 array (for a tensor on
    a device, its one device-to-host copy)."""
    if isinstance(arr, torch.Tensor):
        t = arr.cpu().reshape(-1)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().view(np.uint8)
    return arr.reshape(-1).view(np.uint8)


def _describe(arr) -> tuple:
    """(shape, dtype name, itemsize) of a tensor or numpy array."""
    if isinstance(arr, torch.Tensor):
        return list(arr.shape), _dtype_name(arr), arr.element_size()
    return list(arr.shape), str(arr.dtype), arr.dtype.itemsize


def _from_raw(raw: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    """Restored host bytes -> a tensor of ``dtype`` (numpy's name) on
    ``device``."""
    if dtype == "bfloat16":
        t = torch.from_numpy(raw.view(np.int16).reshape(shape)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape))
    return t.to(device)


def _placement_device(sh):
    if isinstance(sh, (str, torch.device)):
        return torch.device(sh)
    dev = getattr(sh, "device", None)
    if dev is None:
        raise TypeError(f"a sharding names a device (or has .device), got {sh!r}")
    return torch.device(dev)


def _leaf_devices(shardings, n: int, one_device: bool) -> list:
    """The device of each of ``n`` leaves: the CPU when ``shardings`` is
    None, else its device(s); a train state lives on one device."""
    if shardings is None:
        return [torch.device("cpu")] * n
    if isinstance(shardings, (str, torch.device)) or hasattr(shardings, "device"):
        return [_placement_device(shardings)] * n
    devs = [_placement_device(sh) for _, sh in _flatten(shardings)]
    if one_device:
        if len(set(devs)) != 1:
            raise ValueError(f"the port's train state lives on one device, not {set(devs)}")
        return [devs[0]] * n
    if len(devs) != n:
        raise ValueError(f"shardings has {len(devs)} leaves, the template {n}")
    return devs


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    compress: bool = True
    keep: int = 3
    lz_window: int = 64
    lz_chunk: int = 4096
    lz_backend: str = "auto"   # compressor registry key; "auto" = the
                               # one-launch fused-mono compressor on a card
    lz_decoder: str = "auto"   # decode registry key; "auto" = the one-launch
                               # fused-mono decoder on a card (restores
                               # decode straight from the stored blobs)
    lz_chunks_per_block: object = None  # the reference's TPU block geometry,
                               # kept so configs cross; no Hopper kernel
                               # reads it
    lz_mesh: object = None     # split each per-dtype-class batched dispatch
                               # over this sequence of devices ("sharded"
                               # registry pair); blobs on disk stay
                               # byte-identical, so a checkpoint written on
                               # one mesh restores on any other
                               # (runtime/elastic.py re-points lz_mesh)
    lz_batch_axis: object = None
    lz_lossy_eb: object = None  # error-bounded lossy compression of f32
                               # leaves (lossy-fz codec: each restored
                               # element within eb of the saved value,
                               # non-finite exact); every other dtype — and
                               # all leaves when None — stays lossless.
                               # Lossy leaves CRC the stored blob instead of
                               # the raw bytes.
    async_writes: bool = False  # hand blob/manifest/commit writes to the
                               # double-buffered background writer; save()
                               # returns before the step is durable and a
                               # write failure surfaces on the NEXT save /
                               # wait_until_finished (AsyncWriteError)
    fs: object = None          # runtime/fault.HostFS seam (FaultyFS in the
                               # crash/fault-injection harness)
    writer: object = None      # injectable AsyncBlobWriter; lazily built
    io_retry: object = None    # runtime/async_io.RetryPolicy for host
                               # writes in BOTH modes (transient-EIO retry)
    io_max_pending: int = 2    # async double-buffer depth: how many steps
                               # may be in flight before save() blocks
    device: object = None      # where the codec runs (None: cuda)

    def __post_init__(self):
        if self.fs is None:
            self.fs = HostFS()
        if self.io_retry is None:
            self.io_retry = RetryPolicy()
        # backpressure of the most recent async save() (seconds the call
        # blocked waiting for writer queue room) — StepGuard's io signal
        self.last_save_io_wait_s = 0.0

    # ------------------------------------------------------------- save

    def _get_writer(self) -> AsyncBlobWriter:
        if self.writer is None:
            self.writer = AsyncBlobWriter(
                fs=self.fs, max_pending_steps=self.io_max_pending,
                retry=self.io_retry,
            )
        return self.writer

    def wait_until_finished(self):
        """Block until every async write has landed; re-raise any
        background failure (AsyncWriteError naming step and path)."""
        if self.writer is not None:
            self.writer.wait_until_finished()

    def writer_stats(self) -> dict:
        return self.writer.stats() if self.writer is not None else {}

    def _lz_config(self, symbol_size: int, lossy: bool = False) -> lzss.LZSSConfig:
        # "auto" backend/decoder resolve per device at dispatch time; with a
        # mesh they map to the "sharded" pair instead
        backend, decoder = self.lz_backend, self.lz_decoder
        if lossy:
            # the configured backend becomes the lossy container's inner
            # lossless stage (as optim/grad_compress.lossy_grad_config)
            inner = "auto" if backend in ("lossy-fz", "sharded") else backend
            if self.lz_mesh is not None:
                decoder = "sharded" if decoder == "auto" else decoder
            return lzss.LZSSConfig(
                symbol_size=4, window=self.lz_window,
                chunk_symbols=self.lz_chunk,
                chunks_per_block=self.lz_chunks_per_block,
                backend="lossy-fz", decoder=decoder,
                lossy_eb=float(self.lz_lossy_eb), lossy_inner=inner,
                mesh=self.lz_mesh, batch_axis=self.lz_batch_axis,
            )
        if self.lz_mesh is not None:
            backend = "sharded" if backend == "auto" else backend
            decoder = "sharded" if decoder == "auto" else decoder
        return lzss.LZSSConfig(
            symbol_size=symbol_size, window=self.lz_window,
            chunk_symbols=self.lz_chunk,
            chunks_per_block=self.lz_chunks_per_block, backend=backend,
            decoder=decoder, mesh=self.lz_mesh,
            batch_axis=self.lz_batch_axis,
        )

    def save(self, state, step: int) -> str:
        """Write one step.  Sync mode publishes before returning; async
        mode queues blobs group by group and returns once the commit op is
        queued (the step publishes in the background, in queue order)."""
        fs = self.fs
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        writer = None
        self.last_save_io_wait_s = 0.0
        if self.async_writes:
            # begin_step re-raises any prior background failure and blocks
            # while the double-buffer window is full.  A step saved again
            # while its first save is still in flight waits for it to land:
            # staging removes the step's tmp dir, which the writer still
            # fills (the reference removes it under the writer)
            writer = self._get_writer()
            t0 = time.monotonic()
            if step in writer.in_flight():
                writer.wait_until_finished()
            writer.begin_step(step)
            self.last_save_io_wait_s = time.monotonic() - t0
        fs.makedirs(self.directory, exist_ok=True)
        if fs.exists(tmp):
            fs.rmtree(tmp)
        fs.makedirs(tmp)

        if writer is None:
            def emit(fname: str, data) -> None:
                path = os.path.join(tmp, fname)
                self.io_retry.run(lambda: fs.write_bytes(path, data))
        else:
            def emit(fname: str, data) -> None:
                writer.put_write(step, os.path.join(tmp, fname), data)

        names, leaves, _ = _leaf_paths(state)
        manifest = {"step": step, "leaves": []}
        entries = []
        groups: dict = {}  # (S, chunk-count bucket, lossy) -> leaf indices
        for i, (name, leaf) in enumerate(zip(names, leaves)):
            arr = _leaf_array(leaf)
            shape, dtype, itemsize = _describe(arr)
            raw = _host_bytes(arr)
            del arr
            fname = name.replace("/", ".") or "scalar"
            entries.append({
                "name": name,
                "shape": shape,
                "dtype": dtype,
                "crc32": zlib.crc32(raw),
                "nbytes": raw.size,
                "file": fname,
            })
            if self.compress and raw.size >= 1024:
                lossy = self.lz_lossy_eb is not None and dtype == "float32"
                s = _symbol_size(itemsize)
                nsym = -(-raw.size // s)
                nc = -(-nsym // self.lz_chunk)
                # bucket by chunk count so a tiny leaf is never padded to a
                # huge leaf's geometry inside the shared batch
                bucket = 1 << max(0, nc - 1).bit_length()
                groups.setdefault((s, bucket, lossy), []).append(i)
            else:
                entries[i]["codec"] = "raw"
                entries[i]["stored_bytes"] = raw.size
                entries[i]["file"] = fname + ".raw"
                emit(entries[i]["file"], raw)
        # one batched compression dispatch per dtype-class group, the
        # leaves' bytes where they lie; in async mode each group's blobs are
        # queued as soon as its dispatch returns
        for (s, _bucket, lossy), idxs in groups.items():
            batch = lzss.compress_many(
                [_leaf_array(leaves[i]) for i in idxs],
                self._lz_config(s, lossy=lossy), device=self.device,
            )
            for j, i in enumerate(idxs):
                res = batch[j]
                entries[i]["codec"] = "gpulz"
                entries[i]["stored_bytes"] = res.total_bytes
                entries[i]["file"] += ".gplz"
                if lossy:
                    # the restored bytes differ from the raw ones by design:
                    # CRC the stored container instead
                    entries[i]["lossy"] = True
                    entries[i]["crc32"] = zlib.crc32(res.data)
                emit(entries[i]["file"], res.data)
            del batch
        manifest["leaves"] = entries
        emit("manifest.json", json.dumps(manifest).encode())
        # the commit marker is written LAST: a crash at any earlier
        # boundary leaves a marker-less dir that steps()/restore/GC treat
        # as nonexistent debris
        emit(COMMIT_MARKER, b"")
        if writer is None:
            if fs.exists(final):
                fs.rmtree(final)
            self.io_retry.run(lambda: fs.rename(tmp, final))
            self._gc()
        else:
            writer.put_commit(step, tmp, final, after=self._gc)
        return final

    # ---------------------------------------------------------- restore

    def steps(self):
        """Committed steps only: a dir without its COMMIT marker is never
        listed and therefore never restorable."""
        fs = self.fs
        if not fs.isdir(self.directory):
            return []
        out = []
        for d in fs.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if not fs.exists(os.path.join(self.directory, d, COMMIT_MARKER)):
                    continue
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _load_step(self, template, step: int, shardings=None):
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {e["name"]: e for e in manifest["leaves"]}
        names, _, rebuild = _leaf_paths(template)
        devices = _leaf_devices(shardings, len(names), convert.is_train_state(template))
        # batched restore: one decompression dispatch per container geometry
        blobs, geom_groups = {}, {}
        for name in names:
            e = by_name[name]
            if e["codec"] != "gpulz":
                continue
            blob = np.fromfile(os.path.join(d, e["file"]), np.uint8)
            if e.get("lossy") and zlib.crc32(blob) != e["crc32"]:
                # lossy leaves CRC the stored container; verify before decode
                raise IOError(f"CRC mismatch for {name} at step {step}")
            h = lzss.fmt.parse_header(blob)
            blobs[name] = blob
            # version + method byte join the batching key so lossless and
            # lossy-fz leaves never share a decompress_many call; lossy
            # blobs also split on their static decode params
            geom_groups.setdefault(
                (h.version, h.method, h.symbol_size, h.chunk_symbols,
                 h.n_chunks, h.lossy_mode, h.inner_method), []
            ).append(name)
        decompressed = {}
        # an explicitly non-sharded lz_decoder + lz_mesh means compress-side
        # sharding only: restore single-device rather than conflicting
        sharded = self.lz_decoder in ("auto", "sharded")
        method_only = {
            lzss.fmt.METHOD_HUFFMAN: "deflate-full",
            lzss.fmt.METHOD_LOSSY: "lossy-fz",
        }
        for gkey, group in geom_groups.items():
            decoder = self.lz_decoder
            if decoder not in ("auto", "sharded") and decoder != \
                    method_only.get(gkey[1]) and (
                        decoder in method_only.values()
                        or gkey[1] in method_only
                    ):
                # decoder/method mismatch: fall back per group — the
                # container's method byte routes to the right decoder
                decoder = "auto"
            raws = lzss.decompress_many(
                [blobs.pop(n) for n in group], decoder=decoder, device=self.device,
                mesh=self.lz_mesh if sharded else None,
                batch_axis=self.lz_batch_axis if sharded else None,
            )
            decompressed.update(zip(group, raws))
            del raws
        out = []
        for name, dev in zip(names, devices):
            e = by_name[name]
            if e["codec"] == "gpulz":
                raw = decompressed.pop(name)
            else:
                raw = np.fromfile(os.path.join(d, e["file"]), np.uint8)
            if not e.get("lossy") and zlib.crc32(raw) != e["crc32"]:
                raise IOError(f"CRC mismatch for {name} at step {step}")
            out.append(_from_raw(raw, e["dtype"], e["shape"], dev))
        return rebuild(out, devices[0] if devices else torch.device("cpu")), manifest["step"]

    def restore(self, template, step: int, shardings=None):
        return self._load_step(template, step, shardings)

    def restore_latest(self, template, shardings=None):
        """Walk back from the newest step until one restores cleanly."""
        for step in reversed(self.steps()):
            try:
                return self._load_step(template, step, shardings)
            except Exception as exc:  # damaged shard/manifest — try older
                print(f"[ckpt] step {step} unusable ({exc}); trying older")
        return None, -1

    def _gc(self):
        """Retention GC, commit-marker- and in-flight-aware.

        * only COMMITTED steps count toward ``keep``;
        * a step the async writer still owns — registered but not yet
          renamed — is never deleted, nor is its staging dir;
        * marker-less ``step_*`` dirs and stale ``*.tmp`` dirs (crash
          debris) are swept once no writer owns them.

        Runs on the writer's thread after each async commit (host file
        operations only) and inline after sync saves.
        """
        fs = self.fs
        if not fs.isdir(self.directory):
            return
        inflight = self.writer.in_flight() if self.writer is not None else set()
        protected = set()
        for s in inflight:
            protected.add(f"step_{s:08d}")
            protected.add(f"step_{s:08d}.tmp")
        for s in self.steps()[: -self.keep]:
            name = f"step_{s:08d}"
            if name in protected:
                continue
            fs.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        for d in fs.listdir(self.directory):
            if not d.startswith("step_") or d in protected:
                continue
            path = os.path.join(self.directory, d)
            if not fs.isdir(path):
                continue
            if d.endswith(".tmp") or not fs.exists(os.path.join(path, COMMIT_MARKER)):
                fs.rmtree(path, ignore_errors=True)

    def stats(self, step: int) -> dict:
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        orig = sum(e["nbytes"] for e in manifest["leaves"])
        stored = sum(e["stored_bytes"] for e in manifest["leaves"])
        return {
            "orig_bytes": orig,
            "stored_bytes": stored,
            "ratio": orig / max(1, stored),
        }
