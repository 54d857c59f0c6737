"""Distributed job farm: pull-based lease server over TCP.

The port of ``inaspeechsegmenter_tpu/parallel/jobs.py`` without pandas:
the same JSON-lines TCP protocol, so a port client works against a JAX
server and a JAX client against a port server, and the same semantics
that make whole-corpus runs idempotent and elastic:

* jobs come from a 2-column csv (source_path, dest_path), stripped,
  de-duplicated and shuffled;
* clients *pull* leases of `nbjobs` (default 20) jobs; a crashed client's
  leased jobs are simply lost for that run and recovered by re-running with
  `skipifexist=True`;
* `set_jobs` can re-feed a running server; `stop_after_dispatch` ends the
  serve loop once the queue is empty;
* no acks, no heartbeats, results go to the shared filesystem;
* at-most-once execution of a retried request (per-client replay cache).

The server object is usable in-process without any networking.  The farm
is host code; each worker runs its own ``Segmenter`` or
``VoiceFemininityScoring`` on its own device (one worker per GPU).
"""

from __future__ import annotations

import csv
import itertools
import json
import os
import socket
import socketserver
import threading

import numpy as np

# distinguishes JobClient instances within one process (see JobClient)
_CLIENT_COUNTER = itertools.count(1)


def read_jobs_csv(path):
    """A comma-separated csv with ``source_path`` and ``dest_path``
    columns -> ``[(source, dest)]``: both stripped, duplicate pairs
    dropped (first kept), blank lines skipped, then shuffled in the order
    pandas' ``sample(frac=1)`` gives under numpy's global random state."""
    with open(path, newline="") as fh:
        rows = [r for r in csv.reader(fh) if r]
    header = rows[0] if rows else []
    missing = {"source_path", "dest_path"} - set(header)
    if missing:
        raise KeyError(f"{path}: no column {sorted(missing)} in {header}")
    i, j = header.index("source_path"), header.index("dest_path")
    jobs = list(dict.fromkeys((r[i].strip(), r[j].strip())
                              for r in rows[1:]))
    return [jobs[k] for k in np.random.choice(len(jobs), len(jobs),
                                              replace=False)]


class JobServer:
    """In-process job queue with the GenderJobServer interface."""

    def __init__(self, csvjobs=None):
        self.lsource = []
        self.ldest = []
        self.i = 0
        self._lock = threading.Lock()
        if csvjobs is not None:
            self.set_jobs(csvjobs)

    def set_jobs(self, csvjobs):
        jobs = read_jobs_csv(csvjobs)
        with self._lock:
            self.lsource = [s for s, _ in jobs]
            self.ldest = [d for _, d in jobs]
            self.i = 0
        sample = ("(sample: %s -> %s)" % jobs[0] if jobs else "(empty)")
        print("[jobserver] queued %d unique jobs from %s %s"
              % (len(jobs), csvjobs, sample))
        return "%d jobs from %s queued" % (len(jobs), csvjobs)

    def get_job(self, msg):
        with self._lock:
            if not self.lsource:
                # same exception class the reference's pop-from-empty
                # raises (pyro_server.py:54), but without first skewing
                # the lease counter, and with a message that tells the
                # racing worker to drain instead of looking like a crash
                raise IndexError("no jobs left")
            print("[jobserver] lease job #%d to %s" % (self.i, msg))
            self.i += 1
            return (self.lsource.pop(0), self.ldest.pop(0))

    def get_njobs(self, msg, nbjobs=20):
        with self._lock:
            ret = (self.lsource[:nbjobs], self.ldest[:nbjobs])
            if ret[0]:
                print("[jobserver] lease jobs #%d..#%d to %s"
                      % (self.i, self.i + len(ret[0]) - 1, msg))
            else:
                print("[jobserver] queue empty, nothing left to lease")
            self.lsource = self.lsource[nbjobs:]
            self.ldest = self.ldest[nbjobs:]
            # count jobs actually leased: bumping by the REQUESTED size
            # on a short/empty queue would skew every later lease number
            # an operator correlates with corpus progress
            self.i += len(ret[0])
            return ret

    def has_more_jobs(self):
        with self._lock:
            return len(self.lsource) > 0

    # ------------------------------------------------------------------
    def serve(self, host="0.0.0.0", port=0, stop_after_dispatch=False,
              cap=1024):
        """Serve over TCP; returns (server, uri). Call server.shutdown() or
        use stop_after_dispatch to end the loop.

        At-most-once execution for retried requests: clients stamp each
        request with a per-client monotonically increasing ``id``; the
        server caches the last response per client and replays it when the
        same id arrives again (a reconnect-resend after a lost reply).
        Without this, a timed-out ``get_njobs`` whose reply was lost would
        lease the NEXT batch on retry and silently orphan the first one.

        :param cap: LRU bound on the per-client replay/lock maps (one
            entry per distinct client id ever seen; restarted workers
            mint fresh ids, so long re-feed farms need the bound).
            Entries whose request is still EXECUTING are never evicted —
            eviction there would mint a fresh lock for the client's
            retry and let it run concurrently with the original,
            breaking at-most-once.  Eviction of an idle client's entry
            costs at most one replayed lease (the retry re-executes).
        """
        from collections import OrderedDict

        jobserver = self
        replay_lock = threading.Lock()
        replay = OrderedDict()       # client -> (last_id, last_response)
        client_locks = OrderedDict()  # client -> per-client execution lock
        pending = {}                 # client -> requests between lookup and
                                     # release: `lk.locked()` alone cannot
                                     # protect a freshly-minted lock that
                                     # its requester has not acquired YET —
                                     # another handler's eviction pass could
                                     # drop it and a concurrent retry would
                                     # mint a second lock, double-leasing

        def _evict_idle(d, exclude=None):
            # oldest-first, skipping `exclude` (the client being served),
            # clients whose lock is held (request executing) and clients
            # with a request in flight between lock lookup and release
            # (`pending`); if everything is active (fleet > cap), grow —
            # correctness over the bound
            for k in list(d):
                if k == exclude or pending.get(k):
                    continue
                lk = client_locks.get(k)
                if lk is None or not lk.locked():
                    del d[k]
                    return True
            return False

        def _client_lock(client):
            with replay_lock:
                lk = client_locks.get(client)
                if lk is None:
                    lk = client_locks[client] = threading.Lock()
                client_locks.move_to_end(client)
                pending[client] = pending.get(client, 0) + 1
                while len(client_locks) > cap:
                    if not _evict_idle(client_locks, exclude=client):
                        break
                return lk

        def _release_client(client):
            with replay_lock:
                left = pending.get(client, 1) - 1
                if left <= 0:
                    pending.pop(client, None)
                else:
                    pending[client] = left

        def _execute(req):
            try:
                # explicit RPC surface only: everything else on the
                # server object (serve, __init__, _lock, ...) must
                # not be reachable from the network
                if req["method"] not in ("get_job", "get_njobs",
                                         "set_jobs", "has_more_jobs"):
                    raise ValueError(f"unknown method {req['method']!r}")
                method = getattr(jobserver, req["method"])
                result = method(*req.get("args", []),
                                **req.get("kwargs", {}))
                resp = {"result": result}
            except Exception as exc:  # report errors to the client
                resp = {"error": f"{type(exc).__name__}: {exc}"}
            return (json.dumps(resp) + "\n").encode()

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    try:
                        req = json.loads(line)
                        req_id = req.get("id")
                        client = req.get("client")
                    except Exception:
                        req, req_id, client = {"method": None}, None, None
                    if req_id is not None and client is not None:
                        # per-client serialization: a retry that arrives
                        # while the original request is still executing
                        # blocks here and then hits the replay cache,
                        # instead of executing the method a second time
                        try:
                            with _client_lock(client):
                                with replay_lock:
                                    last = replay.get(client)
                                    if last is not None:
                                        replay.move_to_end(client)
                                if last is not None and last[0] == req_id:
                                    payload = last[1]
                                else:
                                    payload = _execute(req)
                                    with replay_lock:
                                        replay[client] = (req_id, payload)
                                        replay.move_to_end(client)
                                        while len(replay) > cap:
                                            # never evict an in-flight
                                            # client's entry: its blocked
                                            # retry is about to need it
                                            if not _evict_idle(
                                                    replay, exclude=client):
                                                break
                        finally:
                            _release_client(client)
                    else:
                        payload = _execute(req)
                    self.wfile.write(payload)
                    self.wfile.flush()
                    if stop_after_dispatch and not jobserver.has_more_jobs():
                        threading.Thread(target=srv.shutdown,
                                         daemon=True).start()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        srv = Server((host, port), Handler)
        uri = "tcp://%s:%d" % srv.server_address[:2]
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        srv._thread = thread
        print("[jobserver] listening on", uri)
        return srv, uri


class JobClient:
    """TCP proxy with the same call surface as the server object.

    Socket operations carry a ``timeout`` and each call retries over a
    fresh connection up to ``reconnect`` times, so a server that dies
    mid-read surfaces a prompt ``ConnectionError`` instead of blocking a
    worker forever in ``readline()`` (the reference's Pyro4 proxy fails
    fast the same way).  Retried requests carry the same per-client
    request id, which the server deduplicates by replaying its cached
    response — so a lease whose reply was lost is re-delivered rather
    than orphaned (and a resent ``set_jobs`` is not executed twice).
    """

    def __init__(self, uri, timeout=30.0, reconnect=2):
        import socket as _socket

        assert uri.startswith("tcp://"), uri
        self.uri = uri
        host, port = uri[len("tcp://"):].rsplit(":", 1)
        self._addr = (host, int(port))
        self.timeout = timeout
        self.reconnect = reconnect
        self.sock = None
        self.rfile = None
        # process-wide monotonic counter, NOT id(self): a freed address
        # can be reused by a later JobClient whose fresh _seq would then
        # collide with the server's replay cache for the dead client
        self._client = "%s-%d-%d" % (_socket.gethostname(), os.getpid(),
                                     next(_CLIENT_COUNTER))
        self._seq = 0
        self._connect()

    def _connect(self):
        self.sock = socket.create_connection(self._addr,
                                             timeout=self.timeout)
        self.sock.settimeout(self.timeout)
        self.rfile = self.sock.makefile("r")

    def _drop(self):
        for closer in (self.rfile, self.sock):
            try:
                if closer is not None:
                    closer.close()
            except OSError:
                pass
        self.sock = self.rfile = None

    def _call(self, method, *args, **kwargs):
        import time

        self._seq += 1
        payload = (json.dumps({"method": method, "args": list(args),
                               "kwargs": kwargs, "client": self._client,
                               "id": self._seq}) + "\n").encode()
        last = None
        for attempt in range(self.reconnect + 1):
            try:
                if self.sock is None:
                    self._connect()
                self.sock.sendall(payload)
                line = self.rfile.readline()
                if not line:
                    raise ConnectionError("server closed the connection")
                resp = json.loads(line)
                if "error" in resp:
                    raise RuntimeError(resp["error"])
                return resp["result"]
            except RuntimeError:
                raise              # server-side error: connection is fine
            except (OSError, ValueError) as exc:
                # socket.timeout is OSError; ValueError = torn JSON line
                last = exc
                self._drop()
                if attempt < self.reconnect:
                    time.sleep(0.2 * (attempt + 1))
        raise ConnectionError(
            f"job server at {self.uri} unreachable "
            f"({self.reconnect + 1} attempts, timeout={self.timeout}s): "
            f"{last}") from last

    def get_job(self, msg):
        return tuple(self._call("get_job", msg))

    def get_njobs(self, msg, nbjobs=20):
        a, b = self._call("get_njobs", msg, nbjobs=nbjobs)
        return list(a), list(b)

    def set_jobs(self, csvjobs):
        return self._call("set_jobs", csvjobs)

    def has_more_jobs(self):
        return self._call("has_more_jobs")

    def close(self):
        self._drop()


def client_work_loop(uri, segmenter, hostname=None, timeout=30.0,
                     reconnect=2):
    """Reference client loop (pyro_client.py:64-74): lease 20 jobs, process
    with skipifexist=True / nbtry=3, repeat until the queue is empty.

    Exits with a clear message (instead of hanging) when the server
    vanishes: lease calls time out after ``timeout`` seconds per socket op
    and ``reconnect`` fresh-connection retries.
    """
    import socket as _socket

    hostname = hostname or _socket.gethostname()
    jobserver = JobClient(uri, timeout=timeout, reconnect=reconnect)
    ret = -1
    while True:
        try:
            lsrc, ldst = jobserver.get_njobs("%s %s" % (hostname, ret))
        except ConnectionError as exc:
            print("[jobclient] job server gone, exiting work loop:", exc)
            break
        if len(lsrc) == 0:
            print("[jobclient] queue drained, exiting work loop")
            break
        ret = segmenter.batch_process(lsrc, ldst, skipifexist=True, nbtry=3)
    jobserver.close()
    return ret
