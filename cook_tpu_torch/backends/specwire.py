"""Compact binary framing for the coordinator->agent launch RPC.

The launch hot path ships every matched task's ``LaunchSpec`` to its
agent inside one POST per host per cycle. At bench scale (1k+ matches
per cycle) the JSON encode/decode of those spec lists is a measurable
slice of the dispatch phase, and most of the bytes are repeated field
names. This module frames the exact ``_spec_wire`` dict shape as a
length-prefixed binary record instead:

    frame  := magic "CKS1" | u32 count | spec*
    spec   := str task_id | str job_uuid | str hostname | str command
            | f64 mem | f64 cpus | f64 gpus
            | u32 nenv | (str key, str value)*
            | jstr container              # JSON object, empty = null
            | str progress_regex | str progress_output_file
            | u32 nports | u32 port*
            | jstr uris                   # JSON list (possibly "[]")
            | str traceparent
    str    := u32 byte_length | utf-8 bytes
    jstr   := str carrying a JSON document (rare/nested fields keep
              JSON so the frame format never chases their schema)

All integers are little-endian. The format is *negotiated*, never
assumed: the agent daemon advertises ``"spec_wire": ["cks1"]`` in its
register payload, and the coordinator falls back to the JSON body for
agents that never advertised it (old daemons keep working unmodified).
Decode failures raise ``ValueError`` so the server side can answer 400
exactly like malformed JSON.
"""
from __future__ import annotations

import json
import struct

from cook_tpu_torch.native import consumefold

MAGIC = b"CKS1"
WIRE_FORMAT = "cks1"              # capability token in register payload
CONTENT_TYPE = "application/x-cook-specs"

_U32 = struct.Struct("<I")
_F64x3 = struct.Struct("<ddd")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    out += _U32.pack(len(b))
    out += b


def _pack_spec(out: bytearray, task_id, job_uuid, hostname, command,
               mem, cpus, gpus, env, container, progress_regex,
               progress_output_file, ports, uris, traceparent) -> None:
    """One spec's wire segment, appended to ``out`` (shared by the
    dict and dataclass encoders so the byte shape cannot drift)."""
    _pack_str(out, task_id)
    _pack_str(out, job_uuid)
    _pack_str(out, hostname)
    _pack_str(out, command)
    out += _F64x3.pack(float(mem), float(cpus), float(gpus))
    env = env or {}
    out += _U32.pack(len(env))
    for k, v in env.items():
        _pack_str(out, str(k))
        _pack_str(out, str(v))
    _pack_str(out, "" if container is None
              else json.dumps(container, separators=(",", ":")))
    _pack_str(out, progress_regex or "")
    _pack_str(out, progress_output_file or "")
    ports = ports or []
    out += _U32.pack(len(ports))
    for p in ports:
        out += _U32.pack(int(p))
    _pack_str(out, json.dumps(list(uris or []), separators=(",", ":")))
    _pack_str(out, traceparent or "")


def encode_specs(specs: list[dict]) -> bytes:
    """Frame a list of ``_spec_wire`` dicts (the JSON body's "specs")."""
    out = bytearray(MAGIC)
    out += _U32.pack(len(specs))
    for d in specs:
        _pack_spec(out, d.get("task_id", ""), d.get("job_uuid", ""),
                   d.get("hostname", ""), d.get("command", ""),
                   d.get("mem", 0.0), d.get("cpus", 0.0),
                   d.get("gpus", 0.0), d.get("env"),
                   d.get("container"), d.get("progress_regex", ""),
                   d.get("progress_output_file", ""), d.get("ports"),
                   d.get("uris"), d.get("traceparent", ""))
    return bytes(out)


def encode_spec_segment(spec) -> bytes:
    """One ``LaunchSpec``'s wire segment, encoded directly off the
    dataclass — no ``_spec_wire`` dict in between. The consume lane
    encodes each matched task ONCE (before the launch transaction) and
    the same buffer is spliced into every frame that ships it
    (:func:`frame_segments`), which is the zero-copy half of the
    launch-pipeline optimization: the old path paid a dict build plus
    a full JSON (or frame) encode per spec per POST."""
    out = bytearray()
    _pack_spec(out, spec.task_id, spec.job_uuid, spec.hostname,
               spec.command, spec.mem, spec.cpus, spec.gpus, spec.env,
               spec.container, spec.progress_regex,
               spec.progress_output_file, spec.ports, spec.uris,
               spec.traceparent)
    return bytes(out)


def frame_segments(segments: list[bytes]) -> bytes:
    """Assemble a CKS1 frame from pre-encoded per-spec segments
    (byte-identical to ``encode_specs`` over the same specs). The
    splice runs behind the native consume chokepoint — at bench scale
    a 1k-match cycle frames hundreds of segments per host POST, and
    consumefold does it in one C pass (or one Python join)."""
    return consumefold.frame_concat(
        MAGIC + _U32.pack(len(segments)), segments)


class _Cursor:
    __slots__ = ("data", "off")

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        end = self.off + n
        if n < 0 or end > len(self.data):
            raise ValueError("spec frame truncated")
        b = self.data[self.off:end]
        self.off = end
        return b

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]

    def s(self) -> str:
        return self.take(self.u32()).decode("utf-8")


def decode_specs(data: bytes) -> list[dict]:
    """Inverse of :func:`encode_specs`; raises ValueError when the
    frame is malformed (bad magic, truncation, trailing bytes)."""
    cur = _Cursor(data)
    if cur.take(4) != MAGIC:
        raise ValueError("bad spec frame magic")
    specs = []
    for _ in range(cur.u32()):
        d: dict = {"task_id": cur.s(), "job_uuid": cur.s(),
                   "hostname": cur.s(), "command": cur.s()}
        d["mem"], d["cpus"], d["gpus"] = _F64x3.unpack(cur.take(24))
        d["env"] = {cur.s(): cur.s() for _ in range(cur.u32())}
        raw = cur.s()
        d["container"] = json.loads(raw) if raw else None
        d["progress_regex"] = cur.s()
        d["progress_output_file"] = cur.s()
        d["ports"] = [cur.u32() for _ in range(cur.u32())]
        d["uris"] = json.loads(cur.s())
        d["traceparent"] = cur.s()
        specs.append(d)
    if cur.off != len(data):
        raise ValueError("trailing bytes after spec frame")
    return specs
