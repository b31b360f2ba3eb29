"""Caffe model loader: a pure-Python protobuf wire parser and a
name-matched copy (``bigdl_tpu/utils/caffe_loader.py``).

Parity: ``utils/CaffeLoader.scala:40-160``.  The reference parses a prototxt
(protobuf text format) and a binary ``.caffemodel`` through 96k lines of
protoc-generated Java, then copies each caffe layer's blob(0)/blob(1) into
the BigDL module of the same name as flat arrays (only element counts must
match).  Here the binary is decoded with a ~100-line protobuf *wire-format*
reader — no generated code, no protoc dependency — because we only need four
message types and their public field numbers (caffe.proto):

  NetParameter:      name=1, layers(V1)=2 repeated, layer(V2)=100 repeated
  V1LayerParameter:  name=4, type=5(enum), blobs=6 repeated
  LayerParameter:    name=1, type=2(string), blobs=7 repeated
  BlobProto:         num=1 channels=2 height=3 width=4 (legacy 4-D),
                     data=5 repeated float (packed or not), shape=7
  BlobShape:         dim=1 repeated int64 (packed)

The copy writes each flat caffe blob into the matched port module's
parameter in place, under ``no_grad``, reshaped to the parameter's shape:
the parameter keeps its device and dtype.  Caffe's convolution blob is
(out, in / group, kh, kw) in row-major order, the port's own layout, so a
grouped convolution (AlexNet's) takes its blob as it is.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("bigdl_tpu_torch.utils.caffe_loader")


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def iter_fields(data) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) triples from one message.

    value is: int for wiretype 0; bytes for 2; raw 8/4-byte chunks for 1/5.
    """
    buf = memoryview(data)
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wtype == 2:
            n, pos = _read_varint(buf, pos)
            val = bytes(buf[pos:pos + n])
            pos += n
        elif wtype == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield field, wtype, val


def _packed_floats(chunks: List[Tuple[int, Any]]) -> np.ndarray:
    """repeated float, packed (wiretype 2) or unpacked (many wiretype 5)."""
    parts = []
    for wtype, val in chunks:
        if wtype == 2:
            parts.append(np.frombuffer(val, dtype="<f4"))
        else:
            parts.append(np.frombuffer(val, dtype="<f4", count=1))
    if not parts:
        return np.zeros((0,), np.float32)
    return np.concatenate(parts)


def _packed_int64(chunks: List[Tuple[int, Any]]) -> List[int]:
    out: List[int] = []
    for wtype, val in chunks:
        if wtype == 2:
            buf = memoryview(val)
            pos = 0
            while pos < len(buf):
                v, pos = _read_varint(buf, pos)
                out.append(v)
        else:
            out.append(int(val))
    return out


def parse_blob(data: bytes) -> Dict[str, Any]:
    """BlobProto -> {"data": float32 array, "shape": [dims]}."""
    legacy = {}
    data_chunks: List[Tuple[int, Any]] = []
    shape_dims: List[int] = []
    for field, wtype, val in iter_fields(data):
        if field in (1, 2, 3, 4) and wtype == 0:  # num/channels/height/width
            legacy[field] = int(val)
        elif field == 5:
            data_chunks.append((wtype, val))
        elif field == 7 and wtype == 2:  # BlobShape
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1:
                    shape_dims.extend(_packed_int64([(w2, v2)]))
    arr = _packed_floats(data_chunks)
    if not shape_dims and legacy:
        shape_dims = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    return {"data": arr, "shape": shape_dims}


def parse_caffemodel(raw: bytes) -> List[Dict[str, Any]]:
    """NetParameter -> list of {"name", "type", "blobs"} layer dicts,
    V1 (`layers`, field 2) and V2 (`layer`, field 100) merged, V2 winning
    on duplicate names like the reference's two maps."""
    layers: List[Dict[str, Any]] = []
    for field, wtype, val in iter_fields(raw):
        if wtype != 2 or field not in (2, 100):
            continue
        layer: Dict[str, Any] = {"name": "", "type": None, "blobs": [],
                                 "v2": field == 100}
        name_field = 1 if field == 100 else 4
        type_field = 2 if field == 100 else 5
        blobs_field = 7 if field == 100 else 6
        for f2, w2, v2 in iter_fields(val):
            if f2 == name_field and w2 == 2:
                layer["name"] = v2.decode("utf-8", "replace")
            elif f2 == type_field:
                layer["type"] = (v2.decode("utf-8", "replace")
                                 if w2 == 2 else int(v2))
            elif f2 == blobs_field and w2 == 2:
                layer["blobs"].append(parse_blob(v2))
        layers.append(layer)
    return layers


# ---------------------------------------------------------------------------
# prototxt (protobuf text format) parser
# ---------------------------------------------------------------------------

def parse_prototxt(text: str) -> Dict[str, Any]:
    """Parse protobuf text format into nested dicts; repeated fields become
    lists.  (TextFormat.merge role, ``CaffeLoader.scala:65-67``.)"""
    import re
    text = re.sub(r"#[^\n]*", "", text)
    tokens = re.findall(
        r'"(?:[^"\\]|\\.)*"|[{}:]|[^\s{}:]+', text)
    pos = 0

    def parse_block() -> Dict[str, Any]:
        nonlocal pos
        out: Dict[str, Any] = {}

        def store(key, value):
            if key in out:
                if not isinstance(out[key], list):
                    out[key] = [out[key]]
                out[key].append(value)
            else:
                out[key] = value

        while pos < len(tokens) and tokens[pos] != "}":
            key = tokens[pos]
            pos += 1
            if pos < len(tokens) and tokens[pos] == ":":
                pos += 1
                raw = tokens[pos]
                pos += 1
                if raw.startswith('"'):
                    value: Any = raw[1:-1]
                else:
                    try:
                        value = int(raw)
                    except ValueError:
                        try:
                            value = float(raw)
                        except ValueError:
                            value = {"true": True,
                                     "false": False}.get(raw, raw)
                store(key, value)
            elif pos < len(tokens) and tokens[pos] == "{":
                pos += 1
                value = parse_block()
                assert tokens[pos] == "}", "unbalanced block"
                pos += 1
                store(key, value)
            else:
                raise ValueError(f"bad prototxt near token {key!r}")
        return out

    return parse_block()


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

class CaffeLoader:
    """Copy caffemodel weights into a port module tree, matched by module
    ``name`` (``CaffeLoader.copyParameters``)."""

    def __init__(self, prototxt_path: str, model_path: str,
                 match_all: bool = True):
        self.prototxt_path = prototxt_path
        self.model_path = model_path
        self.match_all = match_all
        self.layers: Optional[Dict[str, Dict[str, Any]]] = None

    def _load(self) -> None:
        if self.layers is not None:
            return
        # The weight copy keys purely off the binary caffemodel's layer
        # names; the prototxt path is accepted only for ``CaffeLoader.scala``
        # signature parity and is not read (``parse_prototxt`` stays public
        # for callers that want the structure).
        with open(self.model_path, "rb") as f:
            parsed = parse_caffemodel(f.read())
        by_name: Dict[str, Dict[str, Any]] = {}
        for layer in parsed:
            prev = by_name.get(layer["name"])
            if prev is None:
                by_name[layer["name"]] = layer
                continue
            # An entry that actually carries blobs always beats a blob-less
            # duplicate (old bvlc files keep V1 'layers' blobs alongside
            # blob-less V2 'layer' descriptors); only then prefer V2.
            if (bool(layer["blobs"]), layer["v2"]) >= \
                    (bool(prev["blobs"]), prev["v2"]):
                by_name[layer["name"]] = layer
        self.layers = by_name

    def _copy_into(self, module, blobs: List[Dict[str, Any]]) -> None:
        import torch
        params = _own_params(module)
        for key, idx in (("weight", 0), ("bias", 1)):
            if idx >= len(blobs):
                if key in params:
                    # the inverse mismatch: the module expects a parameter
                    # the caffemodel does not provide — it would keep its
                    # random init, silently shifting outputs
                    msg = (f"module {module.name} has a '{key}' parameter "
                           f"but the matched caffe layer provides only "
                           f"{len(blobs)} blob(s); it would keep its "
                           "random init. Rebuild the module without the "
                           "parameter (e.g. with_bias=False) or fix the "
                           "layer mapping.")
                    if self.match_all:
                        raise ValueError(msg)
                    logger.warning(msg)
                continue
            if key not in params:
                # The caffemodel carries a blob the target module cannot
                # hold (typically a conv bias where the model is built with
                # with_bias=False before BN).  Dropping it silently would
                # shift eval outputs — surface it instead.
                blob = np.asarray(blobs[idx]["data"])
                if blob.size and np.any(blob != 0):
                    msg = (f"caffe layer for module {module.name} carries a "
                           f"nonzero '{key}' blob ({blob.size} elems) but "
                           "the module has no such parameter; the value "
                           "would be dropped. Rebuild the module with the "
                           "parameter (e.g. with_bias=True) or fold the "
                           "bias into the following BN's running_mean.")
                    if self.match_all:
                        raise ValueError(msg)
                    logger.warning(msg)
                continue
            flat = blobs[idx]["data"]
            leaf = params[key]
            if flat.size != leaf.numel():
                raise ValueError(
                    f"{key} element number mismatch for {module.name}: "
                    f"caffe {flat.size} (shape {blobs[idx]['shape']}) vs "
                    f"bigdl {leaf.numel()} (shape {list(leaf.shape)})")
            with torch.no_grad():
                leaf.copy_(torch.from_numpy(
                    flat.astype(np.float32).reshape(tuple(leaf.shape))))

    def copy_parameters(self, model):
        from bigdl_tpu_torch.core.module import Container, get_named_modules
        self._load()
        for name, mod in get_named_modules(model).items():
            if isinstance(mod, Container) or "weight" not in _own_params(mod):
                continue
            layer = self.layers.get(name)
            if layer is None:
                if self.match_all:
                    raise KeyError(
                        f"module {name} cannot map a layer in caffe model")
                continue
            if layer["blobs"]:
                self._copy_into(mod, layer["blobs"])
            elif self.match_all:
                raise ValueError(
                    f"caffe layer {name} matched module {name} but carries "
                    f"no blobs — weights would stay randomly initialised")
            else:
                logger.warning(
                    "caffe layer %s has no blobs; %s keeps its init", name,
                    mod.name)
        return model

    @staticmethod
    def load(model, def_path: str, model_path: str, match_all: bool = True):
        return CaffeLoader(def_path, model_path, match_all).copy_parameters(
            model)


def _own_params(module) -> Dict[str, Any]:
    """A layer's own parameters by name (an unset bias left out)."""
    return {k: p for k, p in module._parameters.items() if p is not None}


# ---------------------------------------------------------------------------
# caffemodel writer (fixtures / tests / export)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wtype: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wtype) + payload


def encode_blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    shape_payload = _field(1, 2, (lambda p: _varint(len(p)) + p)(
        b"".join(_varint(int(d)) for d in arr.shape)))
    data = arr.astype("<f4").tobytes()
    return (_field(7, 2, _varint(len(shape_payload)) + shape_payload)
            + _field(5, 2, _varint(len(data)) + data))


def encode_caffemodel(layers: List[Dict[str, Any]],
                      v1: bool = False) -> bytes:
    """Build a binary NetParameter from [{"name", "type", "blobs": [arr]}]."""
    out = b""
    for layer in layers:
        name = layer["name"].encode()
        body = b""
        if v1:
            body += _field(4, 2, _varint(len(name)) + name)
            body += _field(5, 0, _varint(int(layer.get("type", 0) or 0)))
            for arr in layer.get("blobs", []):
                blob = encode_blob(arr)
                body += _field(6, 2, _varint(len(blob)) + blob)
            out += _field(2, 2, _varint(len(body)) + body)
        else:
            body += _field(1, 2, _varint(len(name)) + name)
            tname = str(layer.get("type", "")).encode()
            body += _field(2, 2, _varint(len(tname)) + tname)
            for arr in layer.get("blobs", []):
                blob = encode_blob(arr)
                body += _field(7, 2, _varint(len(blob)) + blob)
            out += _field(100, 2, _varint(len(body)) + body)
    return out
