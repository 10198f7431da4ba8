"""Peer shard tier: survivors serve their RAM-tier shards over HTTP.

Counterpart of ``dlrover_tpu/checkpoint/peer.py``, the same routes and
KV keys, so that a process of either package can fetch from the other.

After a host writes its RAM-tier archive it *advertises* the step in
the master KV store (``ckpt/peer/<step>/<proc> -> http://host:port``).
A relaunched or reshuffled process restoring that step asks the KV
store who holds it and fetches the shards it is missing directly from
survivors' tmpfs copies via the telemetry server's ``/ckpt/shard``
endpoint — the object store drops off the restore critical path
whenever at least one replica of each shard is still alive.

The endpoint speaks two queries (both GET, both step-scoped):

  ``/ckpt/shard?step=N&what=manifest``
      the host's archive manifest JSON — a restore planner can build
      its catalog (global domain maps + what THIS peer holds) from it;
  ``/ckpt/shard?step=N&path=<pkey>&idx=<ikey>``
      one raw ``.npy`` member, addressed by logical shard identity
      (leaf path key + domain key), never by physical member name —
      the peer resolves the member through its own manifest.

Digests are NOT re-verified here: the fetching side verifies every
member against the catalog sha256 before trusting it (loader.py), so
a corrupt peer copy costs one re-fetch, not a poisoned restore.
"""

import io
import json
import urllib.error
import urllib.parse
import urllib.request
import zipfile
from typing import Any, Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.checkpoint import manifest as mf
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import counter, record

__all__ = [
    "PeerRegistry",
    "handle_shard_request",
    "fetch_shard",
    "fetch_manifest",
]

_KV_PREFIX = "ckpt/peer/"


# ------------------------------------------------------------------ server


def handle_shard_request(
    query: str,
    provider: Callable[[int], Optional[str]],
) -> Tuple[int, bytes, str]:
    """Serve one ``/ckpt/shard`` query string. ``provider`` maps a step
    to this host's RAM-tier archive path (None = not held). Returns
    ``(status, body, content_type)`` for the HTTP handler."""
    try:
        params = urllib.parse.parse_qs(query)
        step = int(params["step"][0])
    except (KeyError, ValueError, IndexError):
        return 400, b'{"error": "bad shard query"}', "application/json"
    path = None
    try:
        path = provider(step)
    except Exception as e:
        logger.warning("ckpt shard provider failed: %s", e)
    if path is None:
        return 404, b'{"error": "step not held"}', "application/json"
    try:
        with zipfile.ZipFile(path) as zf:
            man_raw = zf.read("manifest.json")
            if params.get("what", [""])[0] == "manifest":
                _served(step, "manifest", len(man_raw))
                return 200, man_raw, "application/json"
            pkey = params["path"][0]
            ikey = params["idx"][0]
            man = json.loads(man_raw.decode("utf-8"))
            loc = mf._piece_locations(man).get(
                mf.shard_key(pkey, "full" if ikey == "full" else
                             json.loads(ikey))
            )
            if loc is None:
                return (404, b'{"error": "shard not held"}',
                        "application/json")
            body = zf.read(loc["m"])
    except (KeyError, IndexError):
        return 400, b'{"error": "bad shard query"}', "application/json"
    except Exception as e:
        logger.warning("ckpt shard serve failed: %s", e)
        return (500, b'{"error": "unreadable archive"}',
                "application/json")
    _served(step, "member", len(body))
    return 200, body, "application/octet-stream"


def _served(step: int, what: str, nbytes: int) -> None:
    counter(
        "dlrover_ckpt_shard_bytes_total",
        "Checkpoint shard bytes moved, by tier", ["tier"],
    ).labels(tier="peer").inc(nbytes)
    record("ckpt.peer_served", step=step, what=what, bytes=nbytes)


# ------------------------------------------------------------------ client


def _get(url: str, timeout: float) -> Optional[bytes]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise


def fetch_shard(base_url: str, step: int, pkey: str, ikey: str,
                timeout: float = 10.0) -> Optional[bytes]:
    """One member's raw bytes from a peer (None = peer doesn't hold
    it). Raises on transport errors so the caller can count them."""
    q = urllib.parse.urlencode(
        {"step": step, "path": pkey, "idx": ikey}
    )
    return _get(
        base_url.rstrip("/") + "/ckpt/shard?" + q, timeout
    )


def fetch_manifest(base_url: str, step: int,
                   timeout: float = 10.0) -> Optional[Dict[str, Any]]:
    """A peer's archive manifest for one step (None = not held)."""
    raw = _get(
        base_url.rstrip("/")
        + "/ckpt/shard?" + urllib.parse.urlencode(
            {"step": step, "what": "manifest"}
        ),
        timeout,
    )
    if raw is None:
        return None
    return json.loads(raw.decode("utf-8"))


# ---------------------------------------------------------------- registry


class PeerRegistry:
    """Who holds which step, via the master KV store.

    Keys are ``ckpt/peer/<step>/<proc> -> serving URL``. Advertising
    happens right after the RAM-tier write lands; lookups happen at
    restore. Works against any MasterClient/LocalMasterClient; when
    the master predates the ``kv_store_keys`` RPC, step discovery
    degrades to empty (direct ``peers(step)`` lookups still work
    through plain gets when the caller knows the step)."""

    def __init__(self, client, process_index: int, url: str):
        self._client = client
        self._me = int(process_index)
        self._url = url

    def advertise(self, step: int) -> None:
        try:
            self._client.kv_store_set(
                f"{_KV_PREFIX}{int(step)}/{self._me}",
                self._url.encode("utf-8"),
            )
            record(
                "ckpt.peer_advertised", step=int(step),
                process_index=self._me, url=self._url,
            )
        except Exception as e:
            logger.warning("peer advertise failed: %s", e)

    def withdraw(self, step: int) -> None:
        delete = getattr(self._client, "kv_store_delete", None)
        try:
            if delete is not None:
                delete(f"{_KV_PREFIX}{int(step)}/{self._me}")
            else:
                self._client.kv_store_set(
                    f"{_KV_PREFIX}{int(step)}/{self._me}", b""
                )
        except Exception as e:
            logger.warning("peer withdraw failed: %s", e)

    def _keys(self, prefix: str) -> List[str]:
        keys_rpc = getattr(self._client, "kv_store_keys", None)
        if keys_rpc is None:
            return []
        try:
            return list(keys_rpc(prefix))
        except Exception as e:
            logger.warning("peer registry key scan failed: %s", e)
            return []

    def peers(self, step: int) -> Dict[int, str]:
        """proc -> URL for every live advertisement of ``step``."""
        out: Dict[int, str] = {}
        prefix = f"{_KV_PREFIX}{int(step)}/"
        for key in self._keys(prefix):
            try:
                proc = int(key[len(prefix):])
                val = self._client.kv_store_get(key)
            except Exception:
                continue
            if val:
                out[proc] = (
                    val.decode("utf-8")
                    if isinstance(val, (bytes, bytearray)) else str(val)
                )
        return out

    def advertised_steps(self) -> List[int]:
        steps = set()
        for key in self._keys(_KV_PREFIX):
            part = key[len(_KV_PREFIX):].split("/", 1)[0]
            try:
                steps.add(int(part))
            except ValueError:
                continue
        return sorted(steps)
