"""Torch7 ``.t7`` checkpoint reader, importer and writer, copied from
video_filler_tpu/checkpoint/t7.py (the port imports nothing of the JAX
package).  Its trees keep the JAX layout (HWIO numpy dicts by layer name);
checkpoint/convert.py maps them to and from the port's state dicts.

The reference ships/loads ``util.save``/``util.load`` .t7 module graphs
(util.lua:72-105) — e.g. the published ``paris_inpaintCenter.t7`` the demo
uses.  To test parity against such checkpoints, this module implements the
Torch7 binary serialization format (little-endian; type-tagged objects with
memoized references) in pure Python and maps the nn module tree onto our
parameter pytrees.

Format summary (public Torch7 `File:writeObject` layout):
  object := int32 tag, payload
    tag 0 nil | 1 number (f64) | 2 string (i32 len + bytes) | 5 boolean (i32)
    tag 3 table:  i32 ref-index, i32 count, count * (key obj, value obj)
    tag 4 torch:  i32 ref-index, version string ("V <n>") or classname
                  string, [classname string], class payload
  tensor payload:  i32 ndim, i64[ndim] size, i64[ndim] stride,
                   i64 storage_offset (1-based), storage object
  storage payload: i64 size, raw elements

Weight layout mapping (to the JAX package's NHWC/HWIO trees):
  nn.SpatialConvolution     w (out,in,kH,kW)  -> (kH,kW,in,out) transpose
  nn.SpatialFullConvolution w (in,out,kH,kW)  -> (kH,kW,in,out) transpose
  nn.SpatialBatchNormalization weight/bias    -> gamma/beta;
                              running_mean/var -> BN state
(Both Torch conv types are cross-correlations, like ours — no kernel flip.)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_RECUR_FUNCTION = 8
TYPE_LEGACY_RECUR_FUNCTION = 7

_STORAGE_DTYPES = {
    "torch.FloatStorage": ("f", 4),
    "torch.DoubleStorage": ("d", 8),
    "torch.ByteStorage": ("B", 1),
    "torch.CharStorage": ("b", 1),
    "torch.ShortStorage": ("h", 2),
    "torch.IntStorage": ("i", 4),
    "torch.LongStorage": ("q", 8),
    "torch.HalfStorage": ("e", 2),
    # GPU-typed storages: a checkpoint torch.save()d without :float()
    # conversion (util.lua:72-81 clears buffers but cudnn-converted nets keep
    # Cuda tensors) serializes the SAME wire format under cutorch class
    # names — elements are the matching host scalar type.
    "torch.CudaStorage": ("f", 4),
    "torch.CudaDoubleStorage": ("d", 8),
    "torch.CudaByteStorage": ("B", 1),
    "torch.CudaCharStorage": ("b", 1),
    "torch.CudaShortStorage": ("h", 2),
    "torch.CudaIntStorage": ("i", 4),
    "torch.CudaLongStorage": ("q", 8),
    "torch.CudaHalfStorage": ("e", 2),
}
_TENSOR_CLASSES = {
    "torch.FloatTensor", "torch.DoubleTensor", "torch.ByteTensor",
    "torch.CharTensor", "torch.ShortTensor", "torch.IntTensor",
    "torch.LongTensor", "torch.HalfTensor",
    "torch.CudaTensor", "torch.CudaDoubleTensor", "torch.CudaByteTensor",
    "torch.CudaCharTensor", "torch.CudaShortTensor", "torch.CudaIntTensor",
    "torch.CudaLongTensor", "torch.CudaHalfTensor",
}


@dataclass
class TorchObject:
    """A deserialized Torch class instance (e.g. an nn module)."""
    torch_type: str
    fields: dict = field(default_factory=dict)

    def __getitem__(self, k):
        return self.fields[k]

    def get(self, k, default=None):
        return self.fields.get(k, default)


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: dict[int, Any] = {}

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        data = self.f.read(size)
        if len(data) != size:
            raise EOFError("truncated t7 file")
        return struct.unpack("<" + fmt, data)[0]

    def _i32(self) -> int:
        return self._read("i")

    def _i64(self) -> int:
        return self._read("q")

    def _string(self) -> str:
        n = self._i32()
        if n < 0:
            raise ValueError(f"malformed t7 string length {n}")
        data = self.f.read(n)
        if len(data) != n:
            raise EOFError("truncated t7 file")
        return data.decode("latin-1")

    def read_object(self) -> Any:
        tag = self._i32()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            return self._read("d")
        if tag == TYPE_BOOLEAN:
            return bool(self._i32())
        if tag == TYPE_STRING:
            return self._string()
        if tag == TYPE_TABLE:
            idx = self._i32()
            if idx in self.memo:
                return self.memo[idx]
            out: dict = {}
            self.memo[idx] = out
            count = self._i32()
            for _ in range(count):
                k = self.read_object()
                out[k] = self.read_object()
            return out
        if tag == TYPE_TORCH:
            idx = self._i32()
            if idx in self.memo:
                return self.memo[idx]
            version = self._string()
            if version.startswith("V "):
                cls = self._string()
            else:  # very old files: no version record
                cls = version
            return self._read_torch(idx, cls)
        if tag in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                   TYPE_LEGACY_RECUR_FUNCTION):
            idx = self._i32()
            if idx in self.memo:
                return self.memo[idx]
            size = self._i32()
            self.f.read(size)  # dumped lua bytecode — skipped
            upvalues = self.read_object()
            fn = ("<function>", upvalues)
            self.memo[idx] = fn
            return fn
        raise ValueError(f"unknown t7 type tag {tag}")

    def _read_torch(self, idx: int, cls: str):
        if cls in _STORAGE_DTYPES:
            code, _ = _STORAGE_DTYPES[cls]
            n = self._i64()
            if n < 0:
                raise ValueError(f"malformed t7 storage size {n}")
            nbytes = n * np.dtype(code).itemsize
            data = self.f.read(nbytes)
            if len(data) != nbytes:
                raise EOFError("truncated t7 storage")
            arr = np.frombuffer(data, dtype=code).copy()
            self.memo[idx] = arr
            return arr
        if cls in _TENSOR_CLASSES:
            nd = self._i32()
            if nd < 0:
                raise ValueError(f"malformed t7 tensor ndim {nd}")
            size = [self._i64() for _ in range(nd)]
            stride = [self._i64() for _ in range(nd)]
            offset = self._i64() - 1
            placeholder = {}
            self.memo[idx] = placeholder
            storage = self.read_object()
            if storage is None or nd == 0:
                t = np.zeros(size, np.float32)
            else:
                # File-supplied shape/stride/offset feed as_strided below;
                # without these bounds checks a malformed/truncated .t7 would
                # read out-of-bounds host memory (or segfault).
                if (offset < 0 or any(s < 0 for s in size)
                        or any(s < 0 for s in stride)):
                    raise ValueError(
                        f"malformed t7 tensor header (size={size}, "
                        f"stride={stride}, offset={offset + 1})")
                if 0 in size:
                    t = np.zeros(size, storage.dtype)
                else:
                    last = offset + sum(
                        (sz - 1) * st for sz, st in zip(size, stride))
                    if last >= storage.size:
                        raise ValueError(
                            f"t7 tensor exceeds its storage (needs element "
                            f"{last}, storage has {storage.size})")
                    t = np.lib.stride_tricks.as_strided(
                        storage[offset:],
                        shape=size,
                        strides=[s * storage.itemsize for s in stride]).copy()
            self.memo[idx] = t
            return t
        obj = TorchObject(cls)
        self.memo[idx] = obj
        payload = self.read_object()
        if isinstance(payload, dict):
            obj.fields = payload
        else:
            obj.fields = {"_payload": payload}
        return obj


def read_t7(path: str) -> Any:
    with open(path, "rb") as f:
        return _Reader(f).read_object()


# ---------------------------------------------------------------------------
# nn module tree → our parameter pytrees
# ---------------------------------------------------------------------------

_CONTAINERS = {"nn.Sequential", "nn.ParallelTable", "nn.ConcatTable",
               "cudnn.Sequential"}
_CONV = {"nn.SpatialConvolution", "cudnn.SpatialConvolution",
         "nn.SpatialConvolutionMM"}  # MM stores the flattened 2-D weight
                                     # layout _conv_w reshapes
_DECONV = {"nn.SpatialFullConvolution", "cudnn.SpatialFullConvolution"}
_BN = {"nn.SpatialBatchNormalization", "cudnn.SpatialBatchNormalization"}


def flatten_modules(obj: Any) -> list[TorchObject]:
    """Depth-first list of leaf nn modules (containers expanded in order)."""
    out: list[TorchObject] = []
    if isinstance(obj, TorchObject):
        if obj.torch_type in _CONTAINERS:
            mods = obj.get("modules") or {}
            for i in sorted(mods, key=float):
                out.extend(flatten_modules(mods[i]))
        else:
            out.append(obj)
    return out


def _conv_w(m: TorchObject, transposed: bool) -> np.ndarray:
    w = np.asarray(m["weight"], np.float32)
    if w.ndim == 2:  # flattened MM layout (out, in*kh*kw) of SpatialConvolutionMM
        kh, kw = int(m["kH"]), int(m["kW"])
        w = w.reshape(int(m["nOutputPlane"]), int(m["nInputPlane"]), kh, kw)
    if transposed:
        return w.transpose(2, 3, 0, 1)  # (in,out,kH,kW) -> (kH,kW,in,out)
    return w.transpose(2, 3, 1, 0)      # (out,in,kH,kW) -> (kH,kW,in,out)


def import_sequence(modules: list[TorchObject],
                    names: list[str]) -> tuple[dict, dict]:
    """Map an ordered t7 module list onto our sequential layer names.

    `names` is the model's layer-name order (e.g. from
    models/context_encoder.py); conv*/up* consume conv modules, bn* consume
    BN modules, activation names are skipped on both sides.
    """
    params: dict = {}
    state: dict = {}
    mi = 0

    def next_of(kinds):
        nonlocal mi
        while mi < len(modules) and modules[mi].torch_type not in kinds:
            mi += 1
        if mi >= len(modules):
            raise ValueError(f"t7 module stream exhausted looking for {kinds}")
        m = modules[mi]
        mi += 1
        return m

    for name in names:
        if name.startswith(("conv",)):
            m = next_of(_CONV)
            params[name] = {"w": _conv_w(m, transposed=False)}
        elif name.startswith(("up",)):
            m = next_of(_DECONV)
            params[name] = {"w": _conv_w(m, transposed=True)}
        elif name.startswith("bn") or name == "bott_bn":
            m = next_of(_BN)
            params[name] = {"gamma": np.asarray(m["weight"], np.float32),
                            "beta": np.asarray(m["bias"], np.float32)}
            state[name] = {"mean": np.asarray(m["running_mean"], np.float32),
                           "var": np.asarray(m["running_var"], np.float32)}
        # activation / reshape names have no parameters
    return params, state


def import_discriminator(path_or_obj, spec) -> tuple[dict, dict]:
    """Import a reference netD .t7 into (params, state) for
    models.build_discriminator(spec) — 64-in (train.lua:181-199) or 128-in
    (train_vid_weighted.lua:216-227) topologies."""
    obj = read_t7(path_or_obj) if isinstance(path_or_obj, str) else path_or_obj
    mods = flatten_modules(obj)
    if spec.in_size == 64:
        names = ["conv1", "lrelu1"]
    else:
        names = ["conv0", "lrelu0", "conv1", "lrelu1"]
    names += ["conv2", "bn2", "lrelu2", "conv3", "bn3", "lrelu3",
              "conv4", "bn4", "lrelu4", "conv5"]
    return import_sequence(mods, names)


def import_generator(path_or_obj, spec) -> tuple[dict, dict]:
    """Import a reference netG .t7 into (params, state) for
    models.build_generator(spec).  Supports the plain (non-noiseGen)
    topology: netE -> BN+LeakyReLU -> decoder (train.lua:126-148)."""
    obj = read_t7(path_or_obj) if isinstance(path_or_obj, str) else path_or_obj
    mods = flatten_modules(obj)

    enc_names = ["conv0", "lrelu0", "conv1", "bn1", "lrelu1", "conv2", "bn2",
                 "lrelu2", "conv3", "bn3", "lrelu3", "conv4", "bn4", "lrelu4",
                 "conv5"]
    n_up = 5 if spec.out_size == 64 else 6
    dec_names: list[str] = []
    for i in range(n_up):
        dec_names.append(f"up{i}")
        if i < n_up - 1:
            dec_names += [f"bn{i}", f"relu{i}"]

    # Split the flat module stream: encoder convs end at conv5 (the 6th conv).
    conv_seen = 0
    split = 0
    for i, m in enumerate(mods):
        if m.torch_type in _CONV:
            conv_seen += 1
            if conv_seen == 6:
                split = i + 1
                break
    enc_mods, rest = mods[:split], mods[split:]

    enc_params, enc_state = import_sequence(enc_mods, enc_names)
    # bottleneck BN is the first BN after the encoder
    bott_params, bott_state = import_sequence(rest, ["bott_bn"])
    # decoder: everything after that BN
    bi = next(i for i, m in enumerate(rest) if m.torch_type in _BN)
    dec_params, dec_state = import_sequence(rest[bi + 1:], dec_names)

    params = {"enc": enc_params, "bott_bn": bott_params["bott_bn"],
              "dec": dec_params}
    state = {"enc": enc_state, "bott_bn": bott_state["bott_bn"],
             "dec": dec_state}
    return params, state


# ---------------------------------------------------------------------------
# our parameter pytrees → Torch7 .t7 nn module tree (util.save analogue)
# ---------------------------------------------------------------------------

class _Writer:
    """Torch7 binary serializer (the write half of the format above).

    Emits module graphs a real Torch7 `torch.load` can consume (given the
    `nn` package): class instances carry the field tables Torch7's modules
    expect (weight/bias/grad buffers/flags), mirroring what the reference's
    util.save leaves in a checkpoint (util.lua:72-97: float-cast, zeroed
    grads, nn-only modules).
    """

    def __init__(self, f: BinaryIO):
        self.f = f
        self.next_idx = 1

    def _i32(self, v: int) -> None:
        self.f.write(struct.pack("<i", int(v)))

    def _i64(self, v: int) -> None:
        self.f.write(struct.pack("<q", int(v)))

    def _raw_str(self, s: str) -> None:
        b = s.encode("latin-1")
        self._i32(len(b))
        self.f.write(b)

    def write(self, v) -> None:
        if v is None:
            self._i32(TYPE_NIL)
        elif isinstance(v, bool):
            self._i32(TYPE_BOOLEAN)
            self._i32(1 if v else 0)
        elif isinstance(v, (int, float)):
            self._i32(TYPE_NUMBER)
            self.f.write(struct.pack("<d", float(v)))
        elif isinstance(v, str):
            self._i32(TYPE_STRING)
            self._raw_str(v)
        elif isinstance(v, np.ndarray):
            self._tensor(v)
        elif isinstance(v, dict):
            self._i32(TYPE_TABLE)
            self._i32(self.next_idx)
            self.next_idx += 1
            self._i32(len(v))
            for k, val in v.items():
                self.write(k)
                self.write(val)
        elif isinstance(v, TorchObject):
            self._i32(TYPE_TORCH)
            self._i32(self.next_idx)
            self.next_idx += 1
            self._raw_str("V 1")
            self._raw_str(v.torch_type)
            self.write(v.fields)
        else:
            raise TypeError(f"cannot serialize {type(v)}")

    def _tensor(self, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr, np.float32)
        self._i32(TYPE_TORCH)
        self._i32(self.next_idx)
        self.next_idx += 1
        self._raw_str("V 1")
        self._raw_str("torch.FloatTensor")
        self._i32(arr.ndim)
        for s in arr.shape:
            self._i64(s)
        stride = 1
        strides = []
        for s in reversed(arr.shape):
            strides.append(stride)
            stride *= s
        for s in reversed(strides):
            self._i64(s)
        self._i64(1)  # storage offset, 1-based
        self._i32(TYPE_TORCH)
        self._i32(self.next_idx)
        self.next_idx += 1
        self._raw_str("V 1")
        self._raw_str("torch.FloatStorage")
        flat = arr.ravel()
        self._i64(flat.size)
        self.f.write(flat.tobytes())


def _mod(cls: str, **fields) -> TorchObject:
    base = {"train": False, "output": np.zeros((0,), np.float32),
            "gradInput": np.zeros((0,), np.float32)}
    base.update(fields)
    return TorchObject(cls, base)


def _seq_of(mods: list) -> TorchObject:
    return _mod("nn.Sequential",
                modules={float(i + 1): m for i, m in enumerate(mods)})


def _export_conv(w_hwio: np.ndarray, transposed: bool, stride=2, pad=1
                 ) -> TorchObject:
    """(kH,kW,in,out) -> nn.Spatial(Full)Convolution with zero bias (the
    reference zeroes conv biases every step, train.lua:279-280)."""
    kh, kw, cin, cout = w_hwio.shape
    if transposed:
        w = w_hwio.transpose(2, 3, 0, 1)  # (in,out,kH,kW)
        cls = "nn.SpatialFullConvolution"
        extra = {"adjW": 0.0, "adjH": 0.0}
        nbias = cout
    else:
        w = w_hwio.transpose(3, 2, 0, 1)  # (out,in,kH,kW)
        cls = "nn.SpatialConvolution"
        extra = {}
        nbias = cout
    w = np.ascontiguousarray(w, np.float32)
    return _mod(cls, weight=w, bias=np.zeros((nbias,), np.float32),
                gradWeight=np.zeros_like(w),
                gradBias=np.zeros((nbias,), np.float32),
                nInputPlane=float(cin), nOutputPlane=float(cout),
                kW=float(kw), kH=float(kh), dW=float(stride),
                dH=float(stride), padW=float(pad), padH=float(pad), **extra)


def _export_bn(p: dict, s: dict) -> TorchObject:
    g = np.asarray(p["gamma"], np.float32)
    return _mod("nn.SpatialBatchNormalization",
                weight=g, bias=np.asarray(p["beta"], np.float32),
                gradWeight=np.zeros_like(g),
                gradBias=np.zeros_like(g),
                running_mean=np.asarray(s["mean"], np.float32),
                running_var=np.asarray(s["var"], np.float32),
                eps=1e-5, momentum=0.1, affine=True, nDim=4.0)


def export_generator(params, state, spec, path: str) -> None:
    """Write our generator pytree as a reference-format netG .t7
    (encoder -> bott BN + LeakyReLU -> decoder, train.lua:87-148) — the
    util.save analogue, so nets trained here load in actual Torch7 (or round
    -trip through read_t7/import_generator)."""
    if getattr(spec, "noise_gen", False):
        # The plain Sequential below has no noise-join branch; exporting one
        # would produce a net whose dec/up0 (in = nB+nz) cannot consume the
        # nB-wide bottleneck — fail here, not at torch-side :forward.
        raise ValueError("export_generator supports the plain (non-noiseGen) "
                         "topology, matching import_generator")
    lrelu = lambda: _mod("nn.LeakyReLU", negval=0.2, inplace=False)
    relu = lambda: _mod("nn.ReLU", threshold=0.0, val=0.0, inplace=False)

    enc_p, enc_s = params["enc"], state["enc"]
    mods = [_export_conv(np.asarray(enc_p["conv0"]["w"]), False), lrelu()]
    for i in range(1, 5):
        mods += [_export_conv(np.asarray(enc_p[f"conv{i}"]["w"]), False),
                 _export_bn(enc_p[f"bn{i}"], enc_s[f"bn{i}"]), lrelu()]
    mods += [_export_conv(np.asarray(enc_p["conv5"]["w"]), False,
                          stride=1, pad=0)]
    mods += [_export_bn(params["bott_bn"], state["bott_bn"]), lrelu()]
    dec_p, dec_s = params["dec"], state["dec"]
    n_up = 5 if spec.out_size == 64 else 6
    for i in range(n_up):
        first = i == 0
        mods += [_export_conv(np.asarray(dec_p[f"up{i}"]["w"]), True,
                              stride=1 if first else 2, pad=0 if first else 1)]
        if i < n_up - 1:
            mods += [_export_bn(dec_p[f"bn{i}"], dec_s[f"bn{i}"]), relu()]
    mods += [_mod("nn.Tanh")]
    with open(path, "wb") as f:
        _Writer(f).write(_seq_of(mods))

