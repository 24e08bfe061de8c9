"""``ffkv/1``: the versioned, digest-checked KV handoff codec.

Counterpart of ``flexflow_tpu/serve/wire.py``, byte for byte.
``ffdrain/1`` (engine.py) and ``ffkv/1`` carry the same thing, request
state with a per-layer KV spill payload, so they share ONE flattening:
each request becomes named numpy arrays (``r{i}/prompt``,
``r{i}/tokens``, ``r{i}/kv/layer{j}/{k,v[,sk,sv]}``) plus a JSON-able
meta dict, and the whole frame rides with the checkpoint writer's
content digest over the arrays (:func:`flexflow_tpu_torch.model._checkpoint_digest`).
The drain writes that flattening atomically to disk; :func:`encode_handoff`
frames ONE request into in-memory ``.npz`` bytes.

The payload is geometry-free (``PagedKVCache.spill``), so it restores
into a pool of another block size.  Page dtypes in a frame are the JAX
package's: float32 and int8 as they are, float8 e4m3 as ``uint8`` under
a ``kv_dtype: "fp8"`` tag, bfloat16 as raw ``|V2`` (what ``np.savez``
writes for a bfloat16 array).  The port's payloads already hold float8
and bfloat16 pages as those bit views, so no ``ml_dtypes`` is needed,
and the port's frames and digests equal the JAX package's for the same
bits.  One difference: the JAX writer hashes a bfloat16 page under the
dtype string ``bfloat16`` but reads it back as ``|V2``, so its own
bfloat16 frames fail their digest check in both packages; the port
hashes what a reader sees.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flexflow_tpu_torch.model import _checkpoint_digest

__all__ = [
    "KV_SCHEMA",
    "HandoffError",
    "flatten_requests",
    "unflatten_requests",
    "verify_flat",
    "encode_handoff",
    "decode_handoff",
    "kv_payload_nbytes",
]

# wire schema id: bumped only on incompatible layout changes (readers use
# .get for meta keys, so adding one is compatible)
KV_SCHEMA = "ffkv/1"

# meta keys every frame carries (the ffdrain/1 vocabulary)
_META_KEYS = (
    "id", "max_new_tokens", "eos_id", "tenant", "tier", "deadline_ms",
    "preemptions", "session",
)
# latency bookkeeping that may cross a pool boundary with the request
_TIMING_KEYS = (
    "arrival_s", "arrival_abs_s", "t_submit", "t_admitted", "t_first_token",
)


class HandoffError(RuntimeError):
    """A frame that must not be restored: torn bytes, no manifest, the
    wrong schema, or a content-digest mismatch.  The message names what
    failed."""


def flatten_requests(
    requests: List[Dict[str, Any]],
) -> Tuple[Dict[str, np.ndarray], List[Dict[str, Any]]]:
    """Flatten request dicts (the :meth:`ServeEngine.drain` shape) into
    named arrays and JSON-able metas; :func:`unflatten_requests` inverts
    it."""
    flat: Dict[str, np.ndarray] = {}
    metas: List[Dict[str, Any]] = []
    for i, r in enumerate(requests):
        flat[f"r{i}/prompt"] = np.asarray(r["prompt"], np.int32)
        flat[f"r{i}/tokens"] = np.asarray(r.get("tokens", ()), np.int64)
        kv = r.get("kv_spill")
        kv_dtype = None
        if kv is not None:
            # a quantized payload carries its kv_dtype tag and per-layer
            # scale arrays, all covered by the digest
            kv_dtype = kv.get("kv_dtype")
            for lname, d in kv["layers"].items():
                k, v = np.asarray(d["k"]), np.asarray(d["v"])
                if kv_dtype == "fp8":  # float8 travels as its uint8 bits
                    k, v = k.view(np.uint8), v.view(np.uint8)
                flat[f"r{i}/kv/{lname}/k"] = k
                flat[f"r{i}/kv/{lname}/v"] = v
                if "sk" in d:
                    flat[f"r{i}/kv/{lname}/sk"] = np.asarray(d["sk"], np.float32)
                    flat[f"r{i}/kv/{lname}/sv"] = np.asarray(d["sv"], np.float32)
        meta: Dict[str, Any] = {
            "id": int(r["id"]),
            "max_new_tokens": int(r["max_new_tokens"]),
            "eos_id": r.get("eos_id"),
            "tenant": r.get("tenant", "default"),
            "tier": r.get("tier", "batch"),
            "deadline_ms": r.get("deadline_ms"),
            "preemptions": int(r.get("preemptions", 0)),
            "session": r.get("session"),
            "kv_length": int(kv["length"]) if kv is not None else None,
        }
        if kv_dtype is not None:
            meta["kv_dtype"] = str(kv_dtype)
        for key in _TIMING_KEYS:
            if r.get(key) is not None:
                meta[key] = float(r[key])
        # a trace context rides as JSON bytes under the digest
        tr = r.get("trace")
        if tr is not None:
            flat[f"r{i}/trace"] = np.frombuffer(json.dumps(tr).encode(), dtype=np.uint8)
        metas.append(meta)
    return flat, metas


def unflatten_requests(
    flat: Dict[str, np.ndarray], metas: List[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Rebuild the request dicts :func:`flatten_requests` consumed (what
    :meth:`ServeEngine.resume_from_drain` takes).  Pages stay as the
    frame stores them, which is the port's payload convention: a tagged
    ``uint8`` array is float8 e4m3 bits, a ``|V2`` array bfloat16 bits."""
    requests: List[Dict[str, Any]] = []
    for i, meta in enumerate(metas):
        kv = None
        if meta.get("kv_length") is not None:
            kv_dtype = meta.get("kv_dtype")
            layers: Dict[str, Any] = {}
            j = 0
            while f"r{i}/kv/layer{j}/k" in flat:
                layer = {"k": flat[f"r{i}/kv/layer{j}/k"], "v": flat[f"r{i}/kv/layer{j}/v"]}
                sk = flat.get(f"r{i}/kv/layer{j}/sk")
                if sk is not None:
                    layer["sk"] = sk
                    layer["sv"] = flat[f"r{i}/kv/layer{j}/sv"]
                layers[f"layer{j}"] = layer
                j += 1
            kv = {"length": int(meta["kv_length"]), "layers": layers}
            if kv_dtype is not None:
                kv["kv_dtype"] = str(kv_dtype)
        d: Dict[str, Any] = {
            key: meta.get(key) for key in _META_KEYS + _TIMING_KEYS
            if key in meta or key in _META_KEYS
        }
        d.setdefault("tenant", "default")
        d.setdefault("tier", "batch")
        d["preemptions"] = int(meta.get("preemptions", 0))
        d["prompt"] = flat[f"r{i}/prompt"]
        d["tokens"] = [int(t) for t in flat[f"r{i}/tokens"]]
        d["kv_spill"] = kv
        raw_tr = flat.get(f"r{i}/trace")
        if raw_tr is not None:
            d["trace"] = json.loads(np.asarray(raw_tr).tobytes().decode())
        requests.append(d)
    return requests


def verify_flat(
    flat: Dict[str, np.ndarray], what: str, want_schema: Optional[str] = None,
) -> Dict[str, Any]:
    """Pop ``meta/manifest`` from ``flat`` (in place), parse it and check
    the digest of the remaining arrays.  Returns the manifest; raises
    :class:`HandoffError` when the frame lies about its contents."""
    raw = flat.pop("meta/manifest", None)
    if raw is None:
        raise HandoffError(f"{what} has no manifest: not a {want_schema or 'ffkv/ffdrain'} payload")
    manifest = json.loads(np.asarray(raw).tobytes().decode())
    if want_schema is not None and manifest.get("schema") != want_schema:
        raise HandoffError(
            f"{what} carries schema {manifest.get('schema')!r}, expected {want_schema!r}")
    want, got = manifest.get("digest"), _checkpoint_digest(flat)
    if want != got:
        raise HandoffError(
            f"{what} failed its content-digest check: manifest records {want}, payload "
            f"hashes to {got}; refusing to restore")
    return manifest


def encode_handoff(request: Dict[str, Any]) -> bytes:
    """Frame ONE request (``prompt``/``tokens``/``kv_spill`` plus meta) as
    self-describing, digest-stamped ``ffkv/1`` ``.npz`` bytes.  The spill
    arrays are on the host already, so encoding touches no device."""
    flat, metas = flatten_requests([request])
    manifest = {"schema": KV_SCHEMA, "requests": metas, "digest": _checkpoint_digest(flat)}
    payload = dict(flat)
    payload["meta/manifest"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def decode_handoff(data: bytes) -> Dict[str, Any]:
    """Check the digest of one :func:`encode_handoff` frame and unpack it
    into the request dict; torn or tampered frames raise
    :class:`HandoffError`."""
    try:
        with np.load(io.BytesIO(data)) as z:
            flat = {k: np.asarray(z[k]) for k in z.files}
    except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
        raise HandoffError(
            f"handoff frame is torn or truncated ({type(e).__name__}: {e}); refusing to "
            f"restore") from e
    manifest = verify_flat(flat, "handoff frame", want_schema=KV_SCHEMA)
    reqs = unflatten_requests(flat, manifest["requests"])
    if len(reqs) != 1:
        raise HandoffError(f"handoff frame holds {len(reqs)} requests, expected 1")
    return reqs[0]


def kv_payload_nbytes(kv: Optional[Dict[str, Any]]) -> int:
    """Dense bytes of one spill payload (block padding stays in the pool)."""
    if kv is None:
        return 0
    return int(sum(
        d["k"].nbytes + d["v"].nbytes + (d["sk"].nbytes + d["sv"].nbytes if "sk" in d else 0)
        for d in kv["layers"].values()
    ))
