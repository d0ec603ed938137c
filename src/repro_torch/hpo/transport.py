"""Cross-process federation transport: shard workers behind socket RPC
(counterpart of `repro/hpo/transport.py`).

`FederatedGateway` (DESIGN.md §13) time-slices its N shard tickers on one
event loop — horizontal in bookkeeping, vertical in wall-clock.  This
module is the cross-host deployment of the SAME federation core
(DESIGN.md §14): one `StudyGateway` per *worker process*, each hosting
its own ticker, CUDA context, and checkpoint store, fronted by a
`TransportFederation` that routes every call over a socket instead of a
method call.  Per-shard rounds overlap in wall-clock — the paper's
parallel strong-scaling shape, with the surrogate distributed by study.
On one card the workers' host work overlaps and their launches share it.

Layers:

  * **frame codec** — length-prefixed JSON frames (4-byte big-endian
    size + UTF-8 JSON body), the reference's bytes on the wire.
    Everything on the wire is JSON-safe by construction: registry
    records, trial dicts (`unit` as base64 float32), and config specs.  A
    truncated frame is a connection error, never a half-parsed request.
    Requests and replies posted within one event-loop pass coalesce into
    a single `{"batch": [...]}` frame (one syscall carries a whole round
    of asks or a tick's worth of replies).
  * **`ShardServer` / worker** — `python -m repro_torch.hpo.shard_worker
    --ckpt-dir DIR` builds a StudyGateway from `DIR/spec.json` (on the
    spec's `device`), restores from ITS latest epoch, then serves the
    public gateway surface as RPC ops.  `ask`/`drain` run as per-request
    asyncio tasks (they park on the ticker), so one connection multiplexes
    many concurrent asks.  The bind address is published to
    `DIR/endpoint.json` (written atomically AFTER the server is listening
    and the gateway restored).
  * **`ShardClient`** — request-id multiplexed caller.  When the
    connection dies (EOF, reset, or the front end marks the shard dead
    on missed heartbeats), parked `ask` futures are CANCELLED — the
    exact `kill_shard` semantics of the in-memory federation — while
    control-plane calls fail loudly with `ShardConnectionError`.
  * **`TransportFederation`** — `FederationBase` applied over RPC.
    Shard workers are spawned as subprocesses, or adopted with
    `TransportConfig.connect = ("host:port", ...)`.  All stores live
    under ONE shared root: migration is the committed-snapshot protocol
    unchanged — export (quiesce + evict) on the source over RPC,
    `copy_study_version` across the shared root by the front end, adopt
    on the destination, detach from the source, in that order.  Failover
    is health-check driven: `miss_limit` missed pings mark a shard dead;
    `revive_shard` kills any zombie process first, hands the shard to a
    warm standby worker (a front end that spawns shards keeps one, its
    interpreter started, torch imported and its CUDA context made), lets
    it restore from the shard's own epoch, and reconciles it against the
    federation registry over RPC.

The wire, the spec and the stores are the reference's, so a port front
end drives a reference worker and the other way round; the spec's
`device` is the one key a reference worker ignores.

Trial identity over the wire: the worker keeps every suggestion it
handed out in an `(sid, trial_id)` outstanding map; a `tell` resolves
against that map (so the absorb sees the exact object the ticker
produced), moves the key to a resolved set (replays are rejected with
the same "exactly one tell" error as in-process), and tells for trials
this worker never handed out (foreign results) are reconstructed from
their wire form and validated by the normal path.
"""
from __future__ import annotations

import argparse
import asyncio
import base64
import contextlib
import dataclasses
import hashlib
import inspect
import json
import os
import struct
import subprocess
import sys
import time

import numpy as np

import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch.core import acquisition as acq_mod
from repro_torch.core import gp as gp_mod
from repro_torch.core import neural_basis as nb_mod
from repro_torch.hpo.federation import FederationBase, FederationConfig
from repro_torch.hpo.gateway import GatewayConfig, StudyGateway
from repro_torch.hpo.pool import SchedulerConfig, Trial
from repro_torch.hpo.space import (SearchSpace, space_from_dicts,
                                   space_to_dicts)

__all__ = ["TransportConfig", "TransportFederation", "ShardServer",
           "ShardClient", "TransportError", "ShardConnectionError",
           "encode_frame", "read_frame", "build_spec", "gateway_from_spec"]

_MAX_FRAME = 64 << 20  # 64 MiB: larger is a protocol bug, not a payload
ENDPOINT_FILE = "endpoint.json"
SPEC_FILE = "spec.json"
# Set by the front end to time.time() just before it spawns a worker, so
# that the worker can time its interpreter start and imports.
SPAWNED_AT_ENV = "REPRO_WORKER_SPAWNED_AT"


class TransportError(RuntimeError):
    """Malformed traffic on a shard connection (oversized/garbled frame,
    unknown op, worker failed to come up)."""


class ShardConnectionError(TransportError):
    """The connection to a shard worker is gone (EOF/reset, or the front
    end marked the shard dead on missed heartbeats).  Parked asks are
    cancelled instead — see `ShardClient`."""


# -- frame codec -------------------------------------------------------------
def encode_frame(obj: dict) -> bytes:
    """4-byte big-endian length + compact-JSON body."""
    body = json.dumps(obj, separators=(",", ":")).encode()
    if len(body) > _MAX_FRAME:
        raise TransportError(f"frame of {len(body)} bytes exceeds the "
                             f"{_MAX_FRAME}-byte cap")
    return struct.pack(">I", len(body)) + body


async def read_frame(reader: asyncio.StreamReader) -> dict:
    """One complete frame or an exception — never a partial parse.
    Truncation surfaces as `asyncio.IncompleteReadError` (the peer died
    mid-frame); an oversized or non-JSON body is a `TransportError` (the
    stream is desynchronized and the connection must drop)."""
    hdr = await reader.readexactly(4)
    (size,) = struct.unpack(">I", hdr)
    if size > _MAX_FRAME:
        raise TransportError(
            f"incoming frame claims {size} bytes (cap {_MAX_FRAME}); "
            "stream is desynchronized")
    body = await reader.readexactly(size)
    try:
        return json.loads(body)
    except ValueError as e:
        raise TransportError(f"undecodable frame body: {e}") from None


# Errors re-raised client-side with their original type where the type is
# part of the gateway's contract (admission control raises GPCapacityError,
# unknown sids raise KeyError, ...).  Anything else degrades to
# TransportError with the worker-side type in the message.
_WIRE_ERRORS = {
    "GPCapacityError": gp_mod.GPCapacityError,
    # the capacity taxonomy (DESIGN.md §15) crosses the wire intact:
    # clients distinguish a terminal saturation (stop asking / escalate)
    # from retryable backpressure by TYPE, not by message parsing
    "StudySaturatedError": gp_mod.StudySaturatedError,
    "BackpressureError": gp_mod.BackpressureError,
    "KeyError": KeyError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
    "FileNotFoundError": FileNotFoundError,
}


def _decode_error(msg: dict) -> Exception:
    etype = msg.get("etype", "")
    text = msg.get("error", "")
    cls = _WIRE_ERRORS.get(etype)
    if cls is KeyError:
        # KeyError reprs with quotes; the worker sent str(e) which is the
        # quoted message — strip one level so the text round-trips
        return KeyError(text.strip("'\""))
    if cls is not None:
        return cls(text)
    return TransportError(f"shard worker raised {etype}: {text}")


def _host(x, dtype) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype).tobytes()


def study_state_digest(pool, slot: int) -> str:
    """sha256 over every leaf of one slot's GP state (leaf-path sorted).
    The wire-safe BITWISE comparison surface: two gateways serving the
    same study identically must agree on this digest exactly — the
    equivalence suites compare it across process boundaries where the
    raw buffers can't travel.  Leaves are named and typed as the
    reference's `LazyGPState` flattens (its tree paths; float32, and int32
    for the three counters), so a study adopted from a reference snapshot
    digests the same in both packages."""
    st = pool.engine.study_state(slot)
    p = st.params
    f32, i32 = np.float32, np.int32
    leaves = {".x_buf": _host(st.x_buf, f32), ".y_buf": _host(st.y_buf, f32),
              ".l_buf": _host(st.l_buf, f32),
              ".li_buf": _host(st.li_buf, f32),
              ".alpha": _host(st.alpha, f32), ".n": _host(st.n, i32),
              ".since_refit": _host(st.since_refit, i32),
              ".clamp_count": _host(st.clamp_count, i32),
              ".params.sigma2": _host(p.sigma2, f32),
              ".params.rho": _host(p.rho, f32),
              ".params.noise2": _host(p.noise2, f32)}
    h = hashlib.sha256()
    for k in sorted(leaves):
        h.update(k.encode())
        h.update(leaves[k])
    return h.hexdigest()


# -- trial wire form ---------------------------------------------------------
def trial_to_wire(tr: Trial) -> dict:
    # unit travels as base64 of the raw float32 buffer: exact bit
    # round-trip (the equivalence suites compare BITWISE) and far cheaper
    # than per-float decimal repr on the per-suggestion hot path
    unit = np.ascontiguousarray(np.asarray(tr.unit, np.float32))
    return {"trial_id": tr.trial_id,
            "unit_b64": base64.b64encode(unit.tobytes()).decode("ascii"),
            "hparams": tr.hparams, "status": tr.status,
            "value": tr.value, "error": tr.error, "cost": tr.cost}


def trial_from_wire(d: dict) -> Trial:
    if "unit_b64" in d:
        unit = np.frombuffer(base64.b64decode(d["unit_b64"]),
                             np.float32).copy()
    else:  # hand-built wire dicts (tests, foreign tells) may use a list
        unit = np.asarray(d["unit"], np.float32)
    return Trial(int(d["trial_id"]), unit,
                 d.get("hparams") or {}, d.get("status", "pending"),
                 d.get("value"), d.get("error"),
                 cost=float(d.get("cost", 1.0)))


# -- config spec (front end -> worker) ---------------------------------------
def build_spec(space: SearchSpace, cfg: SchedulerConfig,
               gw: GatewayConfig | None = None, *,
               device: str | torch.device = "cuda") -> dict:
    """JSON-safe worker spec: the template space plus both config
    dataclasses, and the device the worker's gateway runs on (a reference
    worker reads only the other three keys).  `ckpt_dir` is intentionally
    dropped — each worker's store is its own `--ckpt-dir` (the shard dir
    under the shared root), never a value serialized on another host."""
    sched = dataclasses.asdict(cfg)
    sched.pop("ckpt_dir")
    return {"space": space_to_dicts(space), "scheduler": sched,
            "gateway": dataclasses.asdict(gw or GatewayConfig()),
            "device": str(device)}


def gateway_from_spec(spec: dict, ckpt_dir: str) -> StudyGateway:
    """The worker's gateway from a spec of either package: the reference's
    `scheduler.implementation` (its linalg substrate) has no counterpart
    here and is dropped; a spec without `device` runs on the card, and
    raises where there is none (`gp.resolve_device`)."""
    sched = dict(spec["scheduler"])
    sched.pop("implementation", None)
    sched["acq"] = acq_mod.AcqConfig(**sched["acq"])
    sched["fantasy"] = gp_mod.FantasyConfig(**sched["fantasy"])
    if "neural" in sched:   # older front ends predate the escalation tier
        sched["neural"] = nb_mod.NeuralConfig(**sched["neural"])
    cfg = SchedulerConfig(ckpt_dir=ckpt_dir, **sched)
    space = space_from_dicts(spec["space"])
    return StudyGateway(space, cfg, GatewayConfig(**spec["gateway"]),
                        device=spec.get("device", "cuda"))


def _write_json_atomic(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# -- wire-level micro-batching -----------------------------------------------
class _BatchWriter:
    """Coalesce every message posted within one event-loop pass into a
    single `{"batch": [...]}` frame (one write syscall).

    `post()` is synchronous: a burst of replies resolved by one tick
    finish — or a round of asks submitted by one `gather` — lands in the
    buffer before the flusher task runs, so the whole burst travels as
    one frame.  Connection errors are swallowed here and surface on the
    reader side (`read_frame` EOF), which owns connection teardown."""

    def __init__(self, writer: asyncio.StreamWriter,
                 on_error=None) -> None:
        self._writer = writer
        self._buf: list[dict] = []
        self._task: asyncio.Task | None = None
        self._on_error = on_error

    def post(self, msg: dict) -> None:
        self._buf.append(msg)
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._flush())

    async def _flush(self) -> None:
        try:
            while self._buf:
                out, self._buf = self._buf, []
                frame = out[0] if len(out) == 1 else {"batch": out}
                self._writer.write(encode_frame(frame))
                await self._writer.drain()
        except (ConnectionError, OSError) as e:
            self._buf = []
            if self._on_error is not None:
                self._on_error(e)

    async def aflush(self) -> None:
        """Wait for everything already posted to hit the socket (used
        before an orderly connection close, e.g. after a shutdown op)."""
        while self._task is not None and not self._task.done():
            await asyncio.shield(self._task)


def _unbatch(msg: dict) -> list[dict]:
    batch = msg.get("batch")
    return batch if isinstance(batch, list) else [msg]


# -- the worker-side server --------------------------------------------------
class ShardServer:
    """Serve one StudyGateway's public surface as RPC ops.

    `ask` and `drain` park on the gateway ticker, so they run as
    per-request tasks — many asks multiplex on one connection and
    coalesce in the worker's tick exactly like in-process clients.
    Control-plane ops run inline, preserving per-connection order (a
    migration's export/adopt/detach sequence must not reorder).
    Dropping a connection cancels its in-flight ask tasks; the gateway
    already tolerates externally-cancelled ask futures (their
    suggestions are released at serve time)."""

    _TASK_OPS = frozenset({"ask", "drain"})

    def __init__(self, gateway: StudyGateway, host: str = "127.0.0.1",
                 port: int = 0):
        self.gw = gateway
        self._host, self._port = host, port
        self._server: asyncio.AbstractServer | None = None
        self._stop = asyncio.Event()
        # suggestions handed out but not yet resolved, by global identity
        self._outstanding: dict[tuple[int, int], Trial] = {}
        self._resolved: set[tuple[int, int]] = set()

    @property
    def address(self) -> tuple[str, int]:
        assert self._server is not None, "server not started"
        host, port = self._server.sockets[0].getsockname()[:2]
        return host, port

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._serve_conn, self._host, self._port)
        return self.address

    async def serve_until_shutdown(self) -> None:
        await self._stop.wait()
        self._server.close()
        await self._server.wait_closed()
        await self.gw.aclose()

    # -- connection loop --
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        out = _BatchWriter(writer)
        tasks: set[asyncio.Task] = set()
        try:
            while True:
                try:
                    frame = await read_frame(reader)
                except (asyncio.IncompleteReadError, TransportError,
                        ConnectionError, OSError):
                    break  # truncated/garbled/dropped: this conn is done
                shutdown = False
                for req in _unbatch(frame):
                    if req.get("op") in self._TASK_OPS:
                        t = asyncio.ensure_future(self._handle(req, out))
                        tasks.add(t)
                        t.add_done_callback(tasks.discard)
                    else:
                        await self._handle(req, out)
                        if req.get("op") == "shutdown":
                            shutdown = True
                if shutdown:
                    await out.aflush()  # the ack must beat the close
                    break
        finally:
            for t in tasks:  # cancel parked asks; the gateway releases
                t.cancel()   # their suggestions at serve time
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle(self, req: dict, out: _BatchWriter) -> None:
        rid = req.get("id")
        op = req.get("op", "")
        try:
            fn = getattr(self, f"_op_{op}", None)
            if fn is None:
                raise TransportError(f"unknown op {op!r}")
            res = fn(**(req.get("args") or {}))
            if inspect.isawaitable(res):
                res = await res
            reply = {"id": rid, "ok": True, "result": res}
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — every gateway error maps
            reply = {"id": rid, "ok": False,
                     "etype": type(e).__name__, "error": str(e)}
        out.post(reply)

    # -- tell identity --
    def _resolve_told(self, sid: int, wire: dict) -> Trial:
        key = (sid, int(wire["trial_id"]))
        if key in self._resolved:
            raise RuntimeError(
                f"trial {key[1]} of study {sid} was already told; "
                "each suggestion takes exactly one tell")
        tr = self._outstanding.get(key)
        if tr is None:
            # a result this worker never suggested (foreign trial):
            # reconstruct and let the normal validation path judge it
            return trial_from_wire(wire)
        return tr

    def _mark_resolved(self, sid: int, wire: dict) -> None:
        key = (sid, int(wire["trial_id"]))
        if self._outstanding.pop(key, None) is not None:
            self._resolved.add(key)

    # -- ops --
    def _op_ping(self) -> dict:
        return {"t": time.time(), "studies": len(self.gw.study_ids())}

    def _op_create_study(self, dims=None, name=None, sid=None):
        space = space_from_dicts(dims) if dims is not None else None
        return self.gw.create_study(space, name, sid=sid)

    def _op_close_study(self, sid):
        self.gw.close_study(sid)

    async def _op_ask(self, sid, q=1):
        res = await self.gw.ask(sid, q)
        trials = res if isinstance(res, list) else [res]
        for tr in trials:
            self._outstanding[(sid, tr.trial_id)] = tr
        return [trial_to_wire(tr) for tr in trials]

    def _op_tell(self, sid, trial, value, cost=1.0):
        tr = self._resolve_told(sid, trial)
        self.gw.tell(sid, tr, value, cost)
        self._mark_resolved(sid, trial)  # only after tell() accepted

    def _op_tell_failure(self, sid, trial, error):
        tr = self._resolve_told(sid, trial)
        self.gw.tell_failure(sid, tr, error)
        self._mark_resolved(sid, trial)

    async def _op_drain(self):
        await self.gw.drain()

    def _op_study_ids(self):
        return self.gw.study_ids()

    def _op_study_info(self, sid):
        return self.gw.study_info(sid)

    def _op_summary(self):
        return self.gw.summary()

    def _op_is_quiescent(self, sid):
        return self.gw.is_quiescent(sid)

    def _op_registry_record(self, sid):
        return self.gw.registry_record(sid)

    def _op_registry_records(self):
        return {str(sid): self.gw.registry_record(sid)
                for sid in self.gw.study_ids()}

    def _op_export_for_migration(self, sid):
        return self.gw.export_for_migration(sid)

    def _op_adopt_study(self, record, require_snapshot=True):
        self.gw.adopt_study(record, require_snapshot=require_snapshot)

    def _op_detach_study(self, sid):
        self.gw.detach_study(sid)

    def _op_expel_study(self, sid):
        self.gw.expel_study(sid)

    def _op_sync_registry(self, next_sid=None, closed_sids=()):
        self.gw.sync_registry(next_sid, closed_sids)

    def _op_checkpoint(self):
        return self.gw.checkpoint() is not None

    def _op_ledger(self, sid):
        """Resident ledger rows (bitwise-comparison surface for the
        equivalence tests); None when the study is evicted — its ledger
        lives in the snapshot."""
        info = self.gw.study_info(sid)
        if info["slot"] is None:
            return None
        return self.gw.pool.history(info["slot"])

    def _op_state_digest(self, sid):
        """Bitwise GP-state digest of a RESIDENT study (None when
        evicted) — see `study_state_digest`."""
        info = self.gw.study_info(sid)
        if info["slot"] is None:
            return None
        return study_state_digest(self.gw.pool, info["slot"])

    def _op_shutdown(self):
        self._stop.set()
        return True


# -- worker entry point ------------------------------------------------------
def _spawn_stages() -> dict:
    """The interpreter's start and imports, from the front end's spawn
    when it says when (`SPAWNED_AT_ENV`)."""
    spawned = os.environ.get(SPAWNED_AT_ENV)
    return {"imports": time.time() - float(spawned) if spawned else None}


def _cuda_context(dev: torch.device) -> bool:
    """Create the CUDA context on `dev` where there is a card; True if
    it did."""
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    return True


async def _worker_main(ckpt_dir: str, spec_path: str, host: str,
                       port: int, stages: dict | None = None) -> None:
    # Seconds of each stage of the start: the interpreter and imports, the
    # CUDA context on a card (both measured by a standby before its
    # assignment, and passed in as `stages`), the gateway, its restore,
    # the bind.
    stages = _spawn_stages() if stages is None else stages
    t = time.perf_counter()

    def stage(name):
        nonlocal t
        now = time.perf_counter()
        stages[name], t = now - t, now

    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device(spec.get("device", "cuda"))
    if "cuda" not in stages and _cuda_context(dev):
        stage("cuda")
    gw = gateway_from_spec(spec, ckpt_dir)
    stage("gateway")
    restored = gw.restore()
    stage("restore")
    server = ShardServer(gw, host, port)
    bound_host, bound_port = await server.start()
    stage("bind")
    # publish the endpoint LAST — its existence means "restored and
    # accepting"; atomic so the front end never reads a partial file
    _write_json_atomic(os.path.join(ckpt_dir, ENDPOINT_FILE),
                       {"host": bound_host, "port": bound_port,
                        "pid": os.getpid(), "restored": restored,
                        "start_seconds": stages})
    print(f"[shard-worker pid={os.getpid()}] serving "
          f"{bound_host}:{bound_port} store={ckpt_dir} "
          f"restored={restored} start_seconds={json.dumps(stages)}",
          file=sys.stderr, flush=True)
    await server.serve_until_shutdown()


def _standby_main(device: str, ready_fd: int, host: str, port: int) -> int:
    """A warm standby: the imports done, the CUDA context made on
    `device` (where there is a card), it writes `ready` to `ready_fd` and
    blocks on one assignment line from stdin, `{"ckpt_dir": ..., "spec":
    ...}`, then starts as a worker of that store.  It touches no store and
    binds no socket before the assignment, and exits if stdin closes
    first (a front end that closed or died)."""
    stages = _spawn_stages()
    t = time.perf_counter()
    if _cuda_context(torch.device(device)):
        stages["cuda"] = time.perf_counter() - t
    try:
        with os.fdopen(ready_fd, "w") as ready:
            ready.write("ready\n")
    except BrokenPipeError:     # the front end stopped waiting: closed
        return 0
    line = sys.stdin.readline()
    if not line:
        return 0
    job = json.loads(line)
    asyncio.run(_worker_main(job["ckpt_dir"], job["spec"], host, port,
                             stages))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="repro_torch federation shard worker: one "
                    "StudyGateway "
                    "behind length-prefixed JSON-frame RPC")
    ap.add_argument("--ckpt-dir", default=None,
                    help="this shard's checkpoint store (a shard dir "
                         "under the shared federation root); required "
                         "unless --standby")
    ap.add_argument("--spec", default=None,
                    help="gateway spec JSON (default <ckpt-dir>/spec.json)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (published in endpoint.json)")
    ap.add_argument("--standby", metavar="DEVICE", default=None,
                    help="written by the front end: start warm on DEVICE, "
                         "say so on --ready-fd, then serve the store of "
                         "one assignment line read from stdin")
    ap.add_argument("--ready-fd", type=int, default=None,
                    help="the pipe a standby writes `ready` to")
    args = ap.parse_args(argv)
    if args.standby is not None:
        if args.ready_fd is None:
            ap.error("--standby needs --ready-fd")
        return _standby_main(args.standby, args.ready_fd, args.host,
                             args.port)
    if args.ckpt_dir is None:
        ap.error("--ckpt-dir is required")
    spec = args.spec or os.path.join(args.ckpt_dir, SPEC_FILE)
    asyncio.run(_worker_main(args.ckpt_dir, spec, args.host, args.port))
    return 0


# -- the front-end client ----------------------------------------------------
class ShardClient:
    """One multiplexed connection to a shard worker.

    Requests carry monotonically increasing ids; a reader task resolves
    response futures out of order (many asks park server-side while
    control calls keep flowing).  Death semantics mirror the in-memory
    federation's `kill_shard`: when the connection is lost or the front
    end marks the shard dead, parked `ask` futures are CANCELLED (those
    clients re-ask elsewhere/later; the per-study PRNG streams make the
    retried round fresh), while every other pending call fails with
    `ShardConnectionError` — a migration step must abort loudly, not
    silently vanish."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, host: str, port: int):
        self._reader, self._writer = reader, writer
        self.host, self.port = host, port
        self._out = _BatchWriter(writer, on_error=self._send_failed)
        self._next_id = 0
        self._pending: dict[int, tuple[str, asyncio.Future]] = {}
        self._dead: str | None = None
        self._reader_task = asyncio.ensure_future(self._read_loop())

    @classmethod
    async def connect(cls, host: str, port: int,
                      timeout: float = 10.0) -> "ShardClient":
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout)
        return cls(reader, writer, host, port)

    @property
    def alive(self) -> bool:
        return self._dead is None

    async def _read_loop(self) -> None:
        try:
            while True:
                frame = await read_frame(self._reader)
                for msg in _unbatch(frame):
                    ent = self._pending.pop(msg.get("id"), None)
                    if ent is None:
                        continue  # late reply for a timed-out/cancelled call
                    _op, fut = ent
                    if fut.done():
                        continue
                    if msg.get("ok"):
                        fut.set_result(msg.get("result"))
                    else:
                        fut.set_exception(_decode_error(msg))
        except (asyncio.IncompleteReadError, TransportError,
                ConnectionError, OSError) as e:
            self._fail_pending(
                f"connection to shard worker {self.host}:{self.port} "
                f"lost ({type(e).__name__}: {e})")
        except asyncio.CancelledError:
            self._fail_pending(self._dead or "shard connection closed")
            raise

    def _send_failed(self, exc: Exception) -> None:
        self._fail_pending(
            f"connection to shard worker {self.host}:{self.port} "
            f"lost mid-send ({type(exc).__name__}: {exc})")

    def _fail_pending(self, reason: str) -> None:
        if self._dead is None:
            self._dead = reason
        pending, self._pending = self._pending, {}
        for op, fut in pending.values():
            if fut.done():
                continue
            if op == "ask":
                fut.cancel()  # kill_shard semantics for parked clients
            else:
                fut.set_exception(ShardConnectionError(reason))

    async def call(self, op: str, _timeout: float | None = None, **args):
        if self._dead is not None:
            raise ShardConnectionError(self._dead)
        rid = self._next_id
        self._next_id += 1
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = (op, fut)
        # posted, not written: every call issued in the same loop pass
        # (a gather'd round of asks, a burst of tells) rides ONE frame.
        # A send failure surfaces through `_fail_pending` on every
        # pending future, this one included.
        self._out.post({"id": rid, "op": op, "args": args})
        if _timeout is None:
            return await fut
        try:
            return await asyncio.wait_for(fut, _timeout)
        finally:
            self._pending.pop(rid, None)

    def close(self, reason: str = "shard connection closed") -> None:
        self._fail_pending(reason)
        self._reader_task.cancel()
        try:
            self._writer.close()
        except (ConnectionError, OSError):
            pass


# -- the front end -----------------------------------------------------------
def _end(proc: subprocess.Popen) -> None:
    """SIGKILL `proc` if it still runs, reap it, and close the pipe to its
    stdin (a standby's)."""
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    if proc.stdin is not None:
        with contextlib.suppress(BrokenPipeError):
            proc.stdin.close()


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Cross-host deployment knobs (routing/registry shape still comes
    from `FederationConfig`)."""

    heartbeat_s: float = 0.0      # background health-check period; 0 =
    # no background task, call check_health() explicitly (tests drive
    # failover deterministically this way)
    heartbeat_timeout_s: float = 1.0  # per-ping reply deadline
    miss_limit: int = 3           # consecutive missed pings -> dead
    spawn_timeout_s: float = 180.0  # worker import+restore+bind budget
    connect: tuple = ()           # adopt operator-started workers: one
    # "host:port" per shard index ("" = spawn that shard locally).
    # Adopted workers must already serve --ckpt-dir <root>/shard-<i> on
    # the SAME shared store root the front end mounts.
    python: str = sys.executable  # interpreter for spawned workers


class TransportFederation(FederationBase):
    """`FederatedGateway` over sockets: same routing, same epochs, same
    recovery law — the shards just live in other processes (one worker
    per host in a real deployment, each on the `device` the spec names:
    the card unless told otherwise).  The whole surface is async (every
    call may cross a machine boundary), including `tell`."""

    def __init__(self, template_space: SearchSpace, cfg: SchedulerConfig,
                 gw: GatewayConfig | None = None,
                 fed: FederationConfig | None = None,
                 transport: TransportConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        super().__init__(template_space, cfg, gw, fed)
        self.device = device
        self.transport = transport or TransportConfig()
        if self.transport.connect and \
                len(self.transport.connect) != self.fed.n_shards:
            raise ValueError(
                f"TransportConfig.connect has "
                f"{len(self.transport.connect)} entries for "
                f"{self.fed.n_shards} shards (use '' to spawn a shard)")
        self.clients: list[ShardClient | None] = [None] * self.fed.n_shards
        self.procs: list[subprocess.Popen | None] = [None] * self.fed.n_shards
        self._misses = [0] * self.fed.n_shards
        # Each spawned worker's start: seconds to its endpoint, and its own
        # stages (`_worker_main`), in spawn order (the shard alone while
        # the worker comes up).  A revive's record counts `endpoint_s` from
        # the assignment and adds `standby_s`, the standby's spawn to its
        # readiness, paid before the kill.
        self.worker_starts: list[dict] = []
        # A front end that spawns any shard keeps one warm standby worker
        # (`revive_shard` hands it a dead shard); its readiness task
        # returns its seconds from spawn to ready.
        self._spawns = not self.transport.connect or \
            "" in self.transport.connect
        self.standby: subprocess.Popen | None = None
        self._standby_ready: asyncio.Task | None = None
        self._health_task: asyncio.Task | None = None
        self._started = False

    # -- lifecycle --
    async def start(self) -> bool:
        """Bring the federation up: load the latest federation epoch if
        one exists (fail-fast on an n_shards mismatch), spawn/adopt every
        shard worker (each restores from ITS own epoch), and reconcile
        restored shards against the registry.  Returns True when a
        federation epoch was restored."""
        restored = self._load_epoch()
        # The workers and the standby start side by side: a worker's start
        # is nearly all its interpreter's imports, which one worker need
        # not wait out for another's.  Every start runs to its end before
        # the first failure, in shard order (the standby last), is raised.
        starts = [self._start_shard(i) for i in range(self.fed.n_shards)]
        if self._spawns:
            self._spawn_standby()
            starts.append(self._standby_ready)
        outs = await asyncio.gather(*starts, return_exceptions=True)
        for out in outs:
            if isinstance(out, BaseException):
                raise out
        if restored:
            for i in range(self.fed.n_shards):
                await self._reconcile_shard_rpc(i)
        if self.transport.heartbeat_s > 0:
            self._health_task = asyncio.ensure_future(self._health_loop())
        self._started = True
        return restored

    async def _start_shard(self, i: int, revive: bool = False) -> None:
        endpoint = self.transport.connect[i] \
            if self.transport.connect else ""
        if endpoint:
            host, port = endpoint.rsplit(":", 1)
            self.clients[i] = await ShardClient.connect(host, int(port))
        else:
            self.clients[i] = await self._spawn_shard(i, standby=revive)
        self._misses[i] = 0

    def _worker_cmd(self, *args: str) -> tuple[list[str], dict]:
        """A worker's command line and environment: the worker must import
        `repro_torch` however the front end did (the parent's sys.path
        does not inherit), so the package root goes first on its
        PYTHONPATH; `SPAWNED_AT_ENV` lets it time its own start."""
        import repro_torch
        pkg_root = os.path.dirname(os.path.dirname(repro_torch.__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env[SPAWNED_AT_ENV] = repr(time.time())
        return [self.transport.python, "-m", "repro_torch.hpo.shard_worker",
                *args], env

    async def _spawn_shard(self, i: int, standby: bool = False) -> ShardClient:
        """Start shard i's worker and connect: a fresh interpreter, or,
        with `standby`, the warm standby given shard i by one assignment
        line (its `Popen` goes into `procs` once it has published its
        endpoint)."""
        d = self.shard_dir(i)
        os.makedirs(d, exist_ok=True)
        spec_path = os.path.join(d, SPEC_FILE)
        _write_json_atomic(spec_path, build_spec(
            self._template_space, self.cfg, self.gw, device=self.device))
        ep_path = os.path.join(d, ENDPOINT_FILE)
        if os.path.exists(ep_path):
            os.unlink(ep_path)
        start = {"shard": i}
        self.worker_starts.append(start)
        if standby:
            proc, start["standby_s"] = await self._take_standby()
            t0 = time.perf_counter()
            try:
                try:
                    proc.stdin.write(json.dumps(
                        {"ckpt_dir": d, "spec": spec_path}).encode() + b"\n")
                    proc.stdin.close()
                except BrokenPipeError:
                    raise TransportError(
                        f"standby worker exited rc={proc.wait()} before "
                        "its assignment") from None
                await self._await_endpoint(i, proc, ep_path)
            except BaseException:
                _end(proc)
                raise
            self.procs[i] = proc
        else:
            cmd, env = self._worker_cmd("--ckpt-dir", d)
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, env=env)
            self.procs[i] = proc
            await self._await_endpoint(i, proc, ep_path)
        with open(ep_path) as f:
            info = json.load(f)
        start.update(endpoint_s=time.perf_counter() - t0,
                     **(info.get("start_seconds") or {}))
        return await ShardClient.connect(info["host"], info["port"])

    async def _await_endpoint(self, i: int, proc: subprocess.Popen,
                              ep_path: str) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.transport.spawn_timeout_s
        while not os.path.exists(ep_path):
            if proc.poll() is not None:
                raise TransportError(
                    f"shard {i} worker exited rc={proc.returncode} "
                    "before publishing its endpoint")
            if loop.time() > deadline:
                proc.kill()
                raise TransportError(
                    f"shard {i} worker did not publish {ep_path} within "
                    f"{self.transport.spawn_timeout_s}s")
            await asyncio.sleep(0.05)

    # -- the standby worker --
    def _spawn_standby(self) -> None:
        """Spawn the standby (`python -m repro_torch.hpo.shard_worker
        --standby DEVICE`, the workers' interpreter and environment) and
        start the task that awaits its `ready` on a pipe of its own."""
        cmd, env = self._worker_cmd("--standby", str(self.device))
        r, w = os.pipe()
        t0 = time.perf_counter()
        try:
            proc = subprocess.Popen(cmd + ["--ready-fd", str(w)], env=env,
                                    stdin=subprocess.PIPE, pass_fds=(w,))
        except BaseException:
            os.close(r)
            raise
        finally:
            os.close(w)
        self.standby = proc
        self._standby_ready = asyncio.ensure_future(
            self._await_ready(proc, r, t0))

    async def _await_ready(self, proc: subprocess.Popen, r: int,
                           t0: float) -> float:
        loop = asyncio.get_running_loop()
        got = loop.create_future()

        def readable():
            if not got.done():
                got.set_result(os.read(r, 64))
        loop.add_reader(r, readable)
        try:
            said = await asyncio.wait_for(got,
                                          self.transport.spawn_timeout_s)
        except asyncio.TimeoutError:
            _end(proc)
            raise TransportError(
                f"standby worker not ready within "
                f"{self.transport.spawn_timeout_s}s") from None
        finally:
            loop.remove_reader(r)
            os.close(r)
        if said != b"ready\n":     # EOF: it closed the pipe as it exited
            raise TransportError(
                f"standby worker exited rc={proc.wait(timeout=10.0)} "
                "before it was ready")
        return time.perf_counter() - t0

    async def _take_standby(self) -> tuple[subprocess.Popen, float]:
        """The standby, awaited until ready, and its seconds from spawn to
        ready; it is no longer the standby.  Raises TransportError with
        its exit code if it has exited."""
        proc, ready = self.standby, self._standby_ready
        if proc is None:
            raise TransportError("no standby worker to revive a shard")
        self.standby = self._standby_ready = None
        try:
            standby_s = await ready
            if proc.poll() is not None:
                raise TransportError(f"standby worker exited "
                                     f"rc={proc.returncode} before its "
                                     "assignment")
        except BaseException:
            _end(proc)
            raise
        return proc, standby_s

    async def aclose(self) -> None:
        if self._health_task is not None:
            self._health_task.cancel()
            self._health_task = None
        for i, c in enumerate(self.clients):
            if c is None:
                continue
            try:
                await c.call("shutdown", _timeout=10.0)
            except (TransportError, asyncio.TimeoutError,
                    asyncio.CancelledError):
                pass
            c.close()
            self.clients[i] = None
        # The standby: a ready one exits on the EOF of its stdin; one
        # still importing holds nothing and is not waited out.
        standby, ready = self.standby, self._standby_ready
        self.standby = self._standby_ready = None
        if ready is not None:
            was_ready = ready.done()
            ready.cancel()
            await asyncio.gather(ready, return_exceptions=True)
            if not was_ready:
                _end(standby)
        if standby is not None:
            standby.stdin.close()
        for p in [*self.procs, standby]:
            if p is None:
                continue
            try:
                p.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                _end(p)
        self.procs = [None] * self.fed.n_shards

    # -- routing plumbing --
    def _live(self, i: int) -> ShardClient:
        c = self.clients[i]
        if c is None:
            raise RuntimeError(f"shard {i} is down; "
                               "revive_shard to restore it from its epoch")
        return c

    def _client_for(self, sid: int) -> ShardClient:
        return self._live(self.shard_of(sid))

    def _live_clients(self) -> list[tuple[int, ShardClient]]:
        return [(i, c) for i, c in enumerate(self.clients) if c is not None]

    # -- study surface --
    async def create_study(self, space: SearchSpace | None = None,
                           name: str | None = None) -> int:
        sid = self._next_sid
        shard = self.route(sid)
        dims = space_to_dicts(space) if space is not None else None
        await self._live(shard).call("create_study", dims=dims, name=name,
                                     sid=sid)
        self._next_sid = sid + 1
        self._placement[sid] = shard
        return sid

    async def close_study(self, sid: int) -> None:
        await self._client_for(sid).call("close_study", sid=sid)
        self._placement.pop(sid, None)
        self._records.pop(sid, None)
        self._closed_sids.add(sid)

    async def ask(self, sid: int, q: int = 1) -> Trial | list[Trial]:
        wires = await self._client_for(sid).call("ask", sid=sid, q=q)
        trials = [trial_from_wire(w) for w in wires]
        return trials if q > 1 else trials[0]

    @staticmethod
    def _tell_wire(trial: Trial) -> dict:
        # tells resolve server-side by (sid, trial_id) against the
        # worker's outstanding map — hparams are derived state the worker
        # recomputes for foreign trials, so don't pay their encode cost
        # on the per-result hot path
        wire = trial_to_wire(trial)
        wire["hparams"] = {}
        return wire

    async def tell(self, sid: int, trial: Trial, value: float,
                   cost: float = 1.0) -> None:
        if trial.status not in ("pending", "running"):
            # same replay law as the in-memory path, without a round trip
            raise RuntimeError(
                f"trial {trial.trial_id} of study {sid} was already told "
                f"({trial.status}); each suggestion takes exactly one tell")
        await self._client_for(sid).call(
            "tell", sid=sid, trial=self._tell_wire(trial),
            value=float(value), cost=float(cost))
        trial.status = "told"  # the worker's copy is authoritative

    async def tell_failure(self, sid: int, trial: Trial,
                           error: str) -> None:
        await self._client_for(sid).call(
            "tell_failure", sid=sid, trial=self._tell_wire(trial),
            error=str(error))
        trial.status = "failed"
        trial.error = str(error)

    async def drain(self) -> None:
        await asyncio.gather(*(c.call("drain")
                               for _i, c in self._live_clients()))

    # -- introspection --
    async def study_info(self, sid: int) -> dict:
        info = await self._client_for(sid).call("study_info", sid=sid)
        info["shard"] = self.shard_of(sid)
        return info

    async def summary(self) -> dict:
        per_shard = {}
        for i, c in self._live_clients():
            per_shard[i] = await c.call("summary")
        return self._merge_summaries(
            per_shard, [i for i, c in enumerate(self.clients) if c is None])

    # -- migration / rebalancing --
    async def migrate_study(self, sid: int, dst: int) -> None:
        """The committed-snapshot migration over RPC.  The front end does
        the store-to-store copy itself (it mounts the shared root), so
        the protocol and its all-or-nothing guarantee are unchanged:
        export evicts into the source shard's store, the copy publishes
        COMMITTED-last into the destination store, adoption refuses
        without that committed version, and only then does the source
        detach.  A front-end crash mid-sequence leaves at worst a
        benign double-registration that the next restore reconciles
        (placement still names the source, so the destination's copy is
        expelled — see DESIGN.md §14)."""
        src = self.shard_of(sid)
        if dst == src:
            return
        src_c, dst_c = self._live(src), self._live(dst)
        record = await src_c.call("export_for_migration", sid=sid)
        if record["evicted_ever"]:
            ckpt_mod.copy_study_version(self.shard_dir(src),
                                        self.shard_dir(dst),
                                        record["key"], record["version"])
        await dst_c.call("adopt_study", record=record,
                         require_snapshot=True)
        await src_c.call("detach_study", sid=sid)
        self._placement[sid] = dst
        self._records[sid] = dict(record, shard=dst)

    async def rebalance(self) -> list[tuple[int, int, int]]:
        moves: list[tuple[int, int, int]] = []
        live = [i for i, c in enumerate(self.clients) if c is not None]
        if len(live) < 2:
            return moves
        while True:
            counts = {i: sum(1 for s in self._placement.values() if s == i)
                      for i in live}
            src = max(live, key=lambda i: (counts[i], i))
            dst = min(live, key=lambda i: (counts[i], i))
            if counts[src] - counts[dst] <= 1:
                return moves
            movable = []
            for sid, s in sorted(self._placement.items()):
                if s == src and await self._live(src).call(
                        "is_quiescent", sid=sid):
                    movable.append(sid)
                    break  # lowest sid wins; no need to scan the rest
            if not movable:
                return moves
            await self.migrate_study(movable[0], dst)
            moves.append((movable[0], src, dst))

    # -- epochs: checkpoint / failover / restore --
    async def _collect_records(self) -> dict[int, dict]:
        by_shard: dict[int, dict] = {}
        for i, c in self._live_clients():
            by_shard[i] = await c.call("registry_records")
        records: dict[int, dict] = {}
        for sid, shard in sorted(self._placement.items()):
            rec = by_shard.get(shard, {}).get(str(sid))
            if rec is not None:
                records[sid] = dict(rec, shard=shard)
            elif sid in self._records:
                records[sid] = self._records[sid]
        return records

    async def checkpoint(self) -> int:
        """Federation epoch over RPC: registry commits FIRST (front-end
        write to the shared root), then each live shard snapshots its own
        store.  Dead shards are skipped — their fallback records ride
        the registry."""
        epoch = self._save_epoch(await self._collect_records())
        for _i, c in self._live_clients():
            await c.call("checkpoint")
        return epoch

    def _mark_dead(self, i: int, reason: str) -> None:
        c = self.clients[i]
        self.clients[i] = None
        if c is not None:
            c.close(reason)

    async def check_health(self) -> list[int]:
        """One ping sweep; marks shards dead at `miss_limit` consecutive
        misses and returns the indices that died THIS sweep."""
        died = []
        for i, c in self._live_clients():
            try:
                await c.call("ping",
                             _timeout=self.transport.heartbeat_timeout_s)
                self._misses[i] = 0
            except (TransportError, asyncio.TimeoutError):
                self._misses[i] += 1
                if self._misses[i] >= self.transport.miss_limit:
                    self._mark_dead(
                        i, f"shard {i} missed {self._misses[i]} "
                           "heartbeats; marked dead")
                    died.append(i)
        return died

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.transport.heartbeat_s)
            await self.check_health()

    def kill_shard(self, i: int) -> None:
        """SIGKILL a spawned worker (adopted workers are just marked
        dead — the front end cannot signal across hosts) and sever its
        connection: parked asks cancel, control calls fail."""
        if self.procs[i] is not None:
            _end(self.procs[i])
        self._mark_dead(i, f"shard {i} killed")

    async def revive_shard(self, i: int) -> None:
        """Bring a dead shard back and fold it in: kill any zombie first
        (a half-dead writer must never touch the store again), hand the
        shard to the warm standby (no interpreter starts on this path),
        let it restore from the shard's latest epoch, then reconcile its
        restored registry against the federation's over RPC — the same
        recovery law as the in-memory `revive_shard`.  A new standby is
        then spawned; a revive before it is ready waits for it.  A
        standby that has exited makes the revive raise TransportError."""
        if self.clients[i] is not None:
            raise RuntimeError(f"shard {i} is already live")
        if self.procs[i] is not None:
            _end(self.procs[i])
        try:
            await self._start_shard(i, revive=True)
            await self._reconcile_shard_rpc(i)
        finally:
            if self._spawns and self.standby is None:
                self._spawn_standby()

    async def _reconcile_shard_rpc(self, i: int) -> None:
        c = self._live(i)
        present = set(await c.call("study_ids"))
        expel, missing = self._reconcile_plan(i, present)
        for sid in expel:
            await c.call("expel_study", sid=sid)
        for sid in missing:
            rec = self._records.get(sid)
            if rec is None:
                await c.call("create_study",
                             dims=space_to_dicts(self._template_space),
                             sid=sid)
            else:
                await c.call("adopt_study", record=rec,
                             require_snapshot=False)
        await c.call("sync_registry", next_sid=self._next_sid,
                     closed_sids=sorted(self._closed_sids))
        for sid in await c.call("study_ids"):
            if self._placement.get(sid) == i:
                self._records[sid] = dict(
                    await c.call("registry_record", sid=sid), shard=i)


if __name__ == "__main__":
    sys.exit(main())
