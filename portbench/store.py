"""The store the traffic reads its prompts from: the program's
`ROS2Client`, built as the mix file's `store` says, filled with the
pool at set-up, and read a request at a time in the window.

Two layouts: "one_file" keeps the pool in one DFS file (a RAG index's
passages) and reads each item as a small random read through the
client's async submit/reap API; "object_per_item" keeps an object per
item (a chat conversation) and reads it with one `pread`.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np

WRITE_CHUNK = 16 << 20
TOKEN_BYTES = 4


def build(store: dict, device):
    from repro_torch.core.client import ROS2Client
    kw = dict(mode=store["mode"], transport=store["transport"],
              n_targets=store["targets"],
              inline_encryption=store["inline_encryption"],
              scrub_interval_s=None, device=device)
    if store.get("ec"):
        kw.update(ec=tuple(store["ec"]), domains=store["domains"],
                  n_devices=store["devices_per_target"])
    else:
        kw.update(replication=store["replication"])
    if "io_depth" in store:
        kw["io_depth"] = store["io_depth"]
    return ROS2Client(**kw)


def delta(after: dict, before: dict) -> dict:
    """after - before of two nested counter dicts, number by number."""
    return {k: delta(v, before.get(k, {})) if isinstance(v, dict)
            else v - before.get(k, 0) for k, v in after.items()
            if isinstance(v, (dict, int, float))}


class Store:
    """A filled store and its read path."""

    def __init__(self, mix: dict, device):
        self.layout = mix["store"]["layout"]
        self.client = build(mix["store"], device)
        self.item_bytes = mix["prompt"]["item_tokens"] * TOKEN_BYTES
        self.warm_reads = mix["store"].get("warm_reads", 0)
        self.fd = None

    def fill(self, pool: np.ndarray) -> None:
        c = self.client
        raw = pool.tobytes()
        if self.layout == "one_file":
            self.fd = c.open("/pool", create=True)
            for off in range(0, len(raw), WRITE_CHUNK):
                c.pwrite(self.fd, raw[off:off + WRITE_CHUNK], off)
        elif self.layout == "object_per_item":
            c.mkdir("/pool")
            for i in range(pool.shape[0]):
                fd = c.open(self._path(i), create=True)
                c.pwrite(fd, raw[i * self.item_bytes:
                                 (i + 1) * self.item_bytes], 0)
        else:
            raise ValueError(f"unknown store layout {self.layout}")

    def warm(self, draw) -> int:
        """A one_file pool read at `warm_reads` items drawn by `draw(n)`
        (the traffic's own popularity, from a seed of its own) through the
        window's read path: the read-side caches (the inline cipher's
        keystream pages, the verified-read cache) left as the traffic
        itself leaves them, the hot items in and the rest turned over, as
        a long-running service keeps them. Cold, the first waves of a run
        read up to 2.5 times as slowly as its later ones. Returns the
        reads made."""
        if self.layout != "one_file":
            return 0
        handles = [self.client.submit_pread(self.fd, self.item_bytes,
                                            int(i) * self.item_bytes)
                   for i in draw(self.warm_reads)]
        for h in handles:
            h.wait()
        return len(handles)

    @staticmethod
    def _path(i: int) -> str:
        return f"/pool/item-{i:07d}"

    def read(self, reqs: List) -> List[dict]:
        """Each request's prompt as the store returns it, with the host
        clock at its send (before its first read) and when its last read
        completed. Requests are sent in order; a one_file read submits
        every item of every request first and then reaps them request by
        request, as clients with many small reads in flight do. A request
        whose read fails comes back with `error` set and no prompt."""
        c, n = self.client, self.item_bytes
        out = []
        if self.layout == "one_file":
            sent = []
            for r in reqs:
                t = time.perf_counter()
                sent.append((t, [c.submit_pread(self.fd, n, int(i) * n)
                                 for i in r.items]))
            for t, handles in sent:
                try:
                    raw = b"".join(h.wait() for h in handles)
                    out.append({"send": t, "read_done": time.perf_counter(),
                                "prompt": np.frombuffer(raw, np.int32)})
                except (IOError, OSError, TimeoutError) as e:
                    out.append({"send": t, "read_done": time.perf_counter(),
                                "error": repr(e)})
            return out
        for r in reqs:
            t = time.perf_counter()
            try:
                fd = c.open(self._path(int(r.items[0])))
                raw = c.pread(fd, n, 0)
                out.append({"send": t, "read_done": time.perf_counter(),
                            "prompt": np.frombuffer(raw, np.int32)})
            except (IOError, OSError, TimeoutError) as e:
                out.append({"send": t, "read_done": time.perf_counter(),
                            "error": repr(e)})
        return out

    def counters(self) -> dict:
        return self.client.io.data_path_counters()

    def close(self) -> None:
        self.client.close()
