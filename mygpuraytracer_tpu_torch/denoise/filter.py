"""OIDN-style Device/Filter API around the port's U-Net.

Counterpart of ``mygpuraytracer_tpu/denoise/filter.py``, which mirrors the
public semantics of the reference denoiser library (include/OpenImageDenoise/
oidn.hpp, core/device.cpp, core/filter.cpp, core/unet.cpp): a Device owns
filters and error state; a Filter takes named images and parameters,
``commit()`` (re)loads the weights only when dirty, and ``execute()``
denoises with overlapped spatial tiling (96 px, unet.h:23) under a
``maxMemoryMB`` budget, progress monitoring and cooperative cancellation.

Images are host arrays (float32 Float3 or float16 Half3, or strided views of
a caller's buffer) or DeviceBuffers (tensors on the filter's device).
``Device()`` runs on CUDA and raises ``OidnError`` without a card;
``Device("cpu")`` runs on the CPU and is asked for only by tests. Without a
progress monitor, ``execute()`` runs every tile on the device in one pass
with no host synchronisation between tiles and one copy back (none for a
DeviceBuffer output); with one, it runs tile by tile through the host. The
convolutions are cuDNN's (denoise/unet.py), in bfloat16 on CUDA and float32
on the CPU.

The ``"mesh"`` parameter (a ``parallel.mesh.Mesh``) shards the single
pass's tile table over the mesh's devices, as the JAX package's does: each
device runs its share of the tiles through its own copy of the U-Net into a
private canvas, and the canvases are summed onto the filter's device. Every
pixel has exactly one writer, so the output equals the single-device
execute bit for bit. As in JAX, a single-tile image and the monitored path
run on the filter's device alone.
"""

from __future__ import annotations

import copy
import math
from typing import Callable

import numpy as np
import torch

from ..parallel.mesh import Mesh, sum_onto
from ..utils.profiling import named_scope
from . import color as color_mod
from . import weights as weights_mod
from .unet import UNET_ALIGNMENT, UNET_RECEPTIVE_FIELD, UNet, net_dtype, no_tf32, round_up


class OidnError(RuntimeError):
    """Error with an OIDN-style code (oidn.h Error enum)."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code

    NONE = "none"
    UNKNOWN = "unknown"
    INVALID_ARGUMENT = "invalid_argument"
    INVALID_OPERATION = "invalid_operation"
    OUT_OF_MEMORY = "out_of_memory"
    UNSUPPORTED_HARDWARE = "unsupported_hardware"
    CANCELLED = "cancelled"


MAX_IMAGE_DIM = 65536  # core/image.h max
DEFAULT_MAX_MEMORY_MB = 3000  # unet.h:38
OVERLAP = round_up(UNET_RECEPTIVE_FIELD // 2, UNET_ALIGNMENT)  # = 96 (unet.h:23)


class DeviceBuffer:
    """Device-resident image buffer, the analog of oidnNewBuffer allocating
    in device memory (oidnBenchmark.cpp:121-165 times ``execute()`` against
    such buffers, with no host traffic in the loop).

    ``array`` is a float32 or float16 tensor on ``device``; other dtypes
    become float32. Attach with ``Filter.set_image``: an output DeviceBuffer
    receives the denoised image on the device with no readback. ``numpy()``
    is the only readback."""

    def __init__(self, array, device="cuda"):
        if isinstance(array, np.ndarray):
            array = np.ascontiguousarray(array)
        t = torch.as_tensor(array, device=device)
        if t.dtype not in (torch.float32, torch.float16):
            t = t.float()
        self.array = t

    @property
    def shape(self):
        return tuple(self.array.shape)

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def ndim(self):
        return self.array.ndim

    def numpy(self) -> np.ndarray:
        """A host copy of the buffer."""
        return self.array.detach().to("cpu", copy=True).numpy()


def _scratch_bytes(tile_h: int, tile_w: int, in_ch: int,
                   output_temp_bytes: int = 0) -> int:
    """Exact U-Net activation scratch size for one padded tile.

    Mirrors UNetFilter::buildNet's end-relative offset/liveness computation
    (core/unet.cpp:356-464) tensor for tensor: each activation is placed
    below the deepest tensor still live when it is produced, and the scratch
    is the deepest offset reached. Sizes are f32 with 64-byte alignment.
    ``output_temp_bytes`` adds the in-place tiled outputTemp image
    (unet.cpp:455-460). PyTorch's caching allocator is not what this counts.
    """
    def size(c: int, scale: int) -> int:
        return round_up(c * (tile_h // scale) * (tile_w // scale) * 4, 64)

    input_ofs = -size(in_ch, 1)
    enc0 = input_ofs - size(32, 1)
    pool1 = input_ofs - size(32, 2)
    enc1 = min(enc0, pool1) - size(32, 1)
    pool2 = pool1 - size(48, 4)
    enc2 = pool2 - size(48, 2)
    pool3 = pool2 - size(64, 8)
    enc3 = pool3 - size(64, 4)
    enc4 = pool3 - size(80, 8)
    enc5a = pool3 - size(96, 16)
    pool4 = min(enc4, enc5a) - size(80, 16)
    up4 = pool3 - size(96, 8)
    enc5b = min(enc5a, up4) - size(96, 16)
    up3 = pool2 - size(112, 4)
    dec4b = up3 - size(112, 8)
    dec4a = min(up4, dec4b) - size(112, 8)
    up2 = pool1 - size(96, 2)
    dec3b = up2 - size(96, 4)
    dec3a = min(up3, dec3b) - size(96, 4)
    up1 = input_ofs - size(64, 1)
    dec2b = up1 - size(64, 2)
    dec2a = min(up2, dec2b) - size(64, 2)
    dec1b = 0 - size(32, 1)
    dec1a = min(up1, dec1b) - size(64, 1)
    dec0 = dec1b - size(3, 1)
    min_ofs = min(enc1, enc2, enc3, pool4, enc5b,
                  dec4a, dec3a, dec2a, dec1a, dec0)
    min_ofs -= output_temp_bytes
    return -min_ofs


def _ceil_div(a: int, b: int) -> int:
    return (a + b - 1) // b


def _torch_device(device_type: str) -> torch.device:
    """"default" and "cuda" mean the current CUDA device, with no fallback;
    "cpu" the CPU."""
    try:
        dev = torch.device("cuda" if device_type == "default" else device_type)
    except (RuntimeError, TypeError):
        raise OidnError(OidnError.INVALID_ARGUMENT, f"unknown device type '{device_type}'") from None
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise OidnError(OidnError.INVALID_ARGUMENT, f"unsupported device type '{device_type}'")
    if not torch.cuda.is_available():
        raise OidnError(OidnError.UNSUPPORTED_HARDWARE,
                        f"device '{device_type}' needs CUDA, and no CUDA device is available")
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


class Device:
    """oidnNewDevice + commit + error state (core/device.cpp)."""

    def __init__(self, device_type: str = "default"):
        self.device_type = device_type
        self.torch_device = _torch_device(device_type)
        self.committed = False
        self.error: tuple[str, str] | None = None
        self.error_fn: Callable[[str, str], None] | None = None
        # Accepted for parity with the reference; no-ops here (the host's
        # threads are PyTorch's).
        self.params = {"numThreads": 0, "setAffinity": True, "verbose": 0}

    def set(self, name: str, value) -> None:
        if name in self.params:
            self.params[name] = value
        else:
            self._warn(f"unknown device parameter '{name}'")

    def get(self, name: str):
        if name in self.params:
            return self.params[name]
        if name == "version":
            return 10402  # OIDN v1.4.2 parity surface
        raise OidnError(OidnError.INVALID_ARGUMENT, f"unknown device parameter '{name}'")

    def set_error_function(self, fn) -> None:
        self.error_fn = fn

    def commit(self) -> None:
        self.committed = True

    def get_error(self) -> tuple[str, str]:
        err = self.error or (OidnError.NONE, "")
        self.error = None
        return err

    def _record_error(self, e: OidnError) -> None:
        self.error = (e.code, str(e))
        if self.error_fn is not None:
            self.error_fn(e.code, str(e))

    def _warn(self, msg: str) -> None:
        if self.params.get("verbose", 0) > 0:
            print(f"warning: {msg}")

    def new_filter(self, kind: str) -> "Filter":
        if not self.committed:
            raise OidnError(OidnError.INVALID_OPERATION, "device not committed")
        if kind == "RT":
            return RTFilter(self)
        if kind == "RTLightmap":
            return RTLightmapFilter(self)
        raise OidnError(OidnError.INVALID_ARGUMENT, f"unknown filter type '{kind}'")


def _check_image(name: str, img):
    if img is None:
        return
    if img.ndim != 3 or img.shape[2] != 3:
        raise OidnError(OidnError.INVALID_ARGUMENT, f"image '{name}' must be HxWx3")
    if isinstance(img, DeviceBuffer):
        return  # DeviceBuffer construction already normalized the dtype
    if img.dtype not in (np.float32, np.float16):
        raise OidnError(
            OidnError.INVALID_ARGUMENT,
            f"image '{name}' must be float32 (Float3) or float16 (Half3)",
        )
    if img.shape[0] > MAX_IMAGE_DIM or img.shape[1] > MAX_IMAGE_DIM:
        raise OidnError(OidnError.INVALID_ARGUMENT, "image size too large")


def _strided_view(buffer: np.ndarray, width: int, height: int,
                  byte_offset: int, pixel_byte_stride: int,
                  row_byte_stride: int) -> np.ndarray:
    """oidnSetFilterImage's (buffer, byteOffset, pixelByteStride,
    rowByteStride) surface (core/image.h:12-66): view an arbitrary
    float16/float32 host buffer as HxWx3 without copying. Stride 0 means
    tightly packed. The view is writable, so it also serves as a strided
    output image."""
    buffer = np.ascontiguousarray(buffer) if not buffer.flags.c_contiguous else buffer
    itemsize = buffer.dtype.itemsize
    if itemsize not in (2, 4):
        raise OidnError(OidnError.INVALID_ARGUMENT, "buffer must be f16/f32")
    pixel = pixel_byte_stride or 3 * itemsize
    row = row_byte_stride or width * pixel
    for s, nm in ((pixel, "pixelByteStride"), (row, "rowByteStride"),
                  (byte_offset, "byteOffset")):
        if s % itemsize:
            raise OidnError(
                OidnError.INVALID_ARGUMENT, f"{nm} not a multiple of the format size"
            )
    end = byte_offset + (height - 1) * row + (width - 1) * pixel + 3 * itemsize
    if height > 0 and width > 0 and end > buffer.nbytes:
        raise OidnError(OidnError.INVALID_ARGUMENT, "image exceeds buffer bounds")
    flat = buffer.reshape(-1)
    return np.lib.stride_tricks.as_strided(
        flat[byte_offset // itemsize :],
        shape=(height, width, 3),
        strides=(row, pixel, itemsize),
    )


def _byte_range(t: torch.Tensor) -> tuple[int, int]:
    """[first, last) bytes a tensor's elements span in its storage."""
    if t.numel() == 0:
        return t.data_ptr(), t.data_ptr()
    span = sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride())) + 1
    return t.data_ptr(), t.data_ptr() + span * t.element_size()


def _aliases(a, b) -> bool:
    """Whether two attached images share memory: numpy's exact test for
    host arrays; identity or overlapping bytes on one device for tensors."""
    if isinstance(a, DeviceBuffer) or isinstance(b, DeviceBuffer):
        if a is b:
            return True
        if not (isinstance(a, DeviceBuffer) and isinstance(b, DeviceBuffer)):
            return False
        if a.array.device != b.array.device:
            return False
        (a0, a1), (b0, b1) = _byte_range(a.array), _byte_range(b.array)
        return a0 < b1 and b0 < a1
    return np.shares_memory(a, b)


class Filter:
    """Base UNetFilter behavior (core/filter.cpp + core/unet.cpp)."""

    _image_slots = ("color", "albedo", "normal", "output")

    def __init__(self, device: Device):
        self.device = device
        self.images: dict[str, np.ndarray | DeviceBuffer | None] = {
            s: None for s in self._image_slots}
        self.params: dict[str, object] = {
            "hdr": False,
            "srgb": False,
            "directional": False,
            "cleanAux": False,
            "maxMemoryMB": DEFAULT_MAX_MEMORY_MB,
            "inputScale": math.nan,
            # A parallel.mesh.Mesh shards the single pass's tile table over
            # its devices (each denoises its share into a private canvas;
            # one sum stitches the disjoint owned regions). None: one device.
            "mesh": None,
        }
        self.progress_fn: Callable[[float], bool] | None = None
        self.dirty = True
        self._committed = False
        self._weights_name = None
        self.using_random_weights = False
        self._user_weights_blob: bytes | None = None
        self._weights_key = None  # what _tensors were loaded from
        self._tensors = None
        self._net: UNet | None = None  # _tensors on the device, in _net.dtype
        self._mesh_nets: dict[torch.device, UNet] = {}  # copies on the mesh's other devices

    # -- parameter surface (oidn.hpp FilterRef) -------------------------------
    def set_image(self, name: str, image, width=None, height=None, byte_offset: int = 0,
                  pixel_byte_stride: int = 0, row_byte_stride: int = 0):
        """Attach an image: an HxWx3 float32 (Float3) or float16 (Half3)
        host array, or, with ``width``/``height`` given, any f16/f32 host
        buffer viewed through oidn.h's byteOffset/pixelByteStride/
        rowByteStride window (core/image.h:12-66); or a DeviceBuffer on the
        filter's device, which takes no window. Views alias the caller's
        buffer, so a strided 'output' writes back in place."""
        if name not in self._image_slots:
            self.device._warn(f"unknown filter image '{name}'")
            return
        if isinstance(image, DeviceBuffer):
            if (width, height) != (None, None) or byte_offset or pixel_byte_stride \
                    or row_byte_stride:
                raise OidnError(OidnError.INVALID_ARGUMENT,
                                f"image '{name}': a DeviceBuffer takes no window or strides")
            if image.array.device != self.device.torch_device:
                raise OidnError(OidnError.INVALID_ARGUMENT,
                                f"image '{name}' lies on {image.array.device}, the filter "
                                f"runs on {self.device.torch_device}")
            _check_image(name, image)
            self.images[name] = image
            self.dirty = True
            return
        if image is not None:
            image = np.asarray(image)
            if width is not None and height is not None and (
                byte_offset or pixel_byte_stride or row_byte_stride
                or image.ndim != 3 or image.shape[:2] != (height, width)
            ):
                image = _strided_view(image, width, height, byte_offset,
                                      pixel_byte_stride, row_byte_stride)
            _check_image(name, image)
        self.images[name] = image
        self.dirty = True

    def remove_image(self, name: str):
        if name in self._image_slots:
            self.images[name] = None
        self.dirty = True

    def set(self, name: str, value):
        if name == "mesh" and value is not None and not isinstance(value, Mesh):
            raise OidnError(OidnError.INVALID_ARGUMENT,
                            "the 'mesh' parameter takes a parallel.mesh.Mesh or None, not "
                            f"{type(value).__name__}")
        if name in self.params:
            self.params[name] = value
            self.dirty = True
        else:
            self.device._warn(f"unknown filter parameter '{name}'")

    def get(self, name: str):
        if name == "alignment":
            return UNET_ALIGNMENT
        if name == "overlap":
            return OVERLAP
        if name in self.params:
            return self.params[name]
        raise OidnError(OidnError.INVALID_ARGUMENT, f"unknown filter parameter '{name}'")

    def set_data(self, name: str, blob: bytes):
        """setData("weights", tza_bytes): user-provided weights override."""
        if name == "weights":
            self._user_weights_blob = bytes(blob)
            self._weights_key = None  # parse at the next commit
            self.dirty = True
        else:
            self.device._warn(f"unknown filter data '{name}'")

    def set_progress_monitor_function(self, fn) -> None:
        self.progress_fn = fn

    # -- commit ---------------------------------------------------------------
    def _features(self) -> tuple[bool, bool, bool]:
        return (
            self.images["color"] is not None,
            self.images["albedo"] is not None,
            self.images["normal"] is not None,
        )

    def _select_weights_name(self) -> str:
        raise NotImplementedError

    def _transfer_kind(self) -> str:
        raise NotImplementedError

    def _snorm(self) -> bool:
        return False

    def commit(self) -> None:
        try:
            self._commit_impl()
        except OidnError as e:
            self.device._record_error(e)
            raise

    def _commit_impl(self) -> None:
        if not self.dirty and self._committed:
            return  # only rebuild when params materially changed (filter.cpp:14-56)
        output = self.images["output"]
        if output is None:
            raise OidnError(OidnError.INVALID_OPERATION, "output image not set")
        h, w = output.shape[:2]
        for name in ("color", "albedo", "normal"):
            img = self.images.get(name)
            if img is not None and img.shape[:2] != (h, w):
                raise OidnError(OidnError.INVALID_OPERATION, "image size mismatch")
        if self.params.get("directional") and (self.params["hdr"] or self.params["srgb"]):
            raise OidnError(
                OidnError.INVALID_OPERATION,
                "directional and hdr/srgb modes cannot be enabled at the same time",
            )
        if self.params["hdr"] and self.params["srgb"]:
            raise OidnError(
                OidnError.INVALID_OPERATION,
                "hdr and srgb modes cannot be enabled at the same time",
            )

        name = self._select_weights_name()
        key = "user" if self._user_weights_blob is not None else name
        if key != self._weights_key:
            if self._user_weights_blob is not None:
                tensors, random_w = weights_mod.load_params_from_blob(self._user_weights_blob)
            else:
                tensors, random_w = weights_mod.load_default_params(name)
            self._tensors, self.using_random_weights = tensors, random_w
            self._weights_key = key
            self._net = None  # weights changed: cast again below
            self._mesh_nets = {}
        self._weights_name = name

        n_in = sum(3 for f in self._features() if f)
        if n_in == 0:
            raise OidnError(
                OidnError.INVALID_OPERATION, "invalid combination of input features"
            )
        have = int(self._tensors["enc_conv0.weight"][0].shape[1])
        if have != n_in:
            raise OidnError(
                OidnError.INVALID_OPERATION,
                f"weights expect {have} input channels, features provide {n_in}",
            )

        self._plan_tiles(h, w)
        self._network()
        self.dirty = False
        self._committed = True

    # -- tiling (unet.cpp:199-239 computeTileSize, exact accounting) ---------
    def _output_aliases_input(self) -> bool:
        output = self.images.get("output")
        if output is None:
            return False
        return any(
            img is not None and _aliases(output, img)
            for name, img in self.images.items()
            if name != "output"
        )

    def _plan_tiles(self, h: int, w: int) -> None:
        """UNetFilter::computeTileSize: split H (then W) until the exact
        scratch size (_scratch_bytes, the buildNet liveness sum) fits the
        maxMemoryMB budget; min tile 3*overlap."""
        max_scratch = int(self.params["maxMemoryMB"]) * (1 << 20)
        min_tile = 3 * OVERLAP
        in_ch = sum(3 for f in self._features() if f)
        inplace = self._output_aliases_input()

        split_h = split_w = 1
        tile_h = round_up(h, UNET_ALIGNMENT)
        tile_w = round_up(w, UNET_ALIGNMENT)

        def counts() -> tuple:
            # Final tile counts (unet.cpp:228-230): one formula for the
            # outputTemp charge below and for self.tile_counts.
            ch = _ceil_div(h - 2 * OVERLAP, tile_h - 2 * OVERLAP) if h > tile_h else 1
            cw = _ceil_div(w - 2 * OVERLAP, tile_w - 2 * OVERLAP) if w > tile_w else 1
            return ch, cw

        def scratch() -> int:
            temp = 0
            ch, cw = counts()
            if inplace and ch * cw > 1:
                temp = round_up(3 * h * w * 4, 64)  # outputTemp, unet.cpp:455
            return _scratch_bytes(tile_h, tile_w, in_ch, temp)

        while scratch() > max_scratch:
            if tile_h > min_tile and tile_h > tile_w:
                split_h += 1
                tile_h = max(
                    round_up(_ceil_div(h - 2 * OVERLAP, split_h),
                             UNET_ALIGNMENT) + 2 * OVERLAP,
                    min_tile,
                )
            elif tile_w > min_tile:
                split_w += 1
                tile_w = max(
                    round_up(_ceil_div(w - 2 * OVERLAP, split_w),
                             UNET_ALIGNMENT) + 2 * OVERLAP,
                    min_tile,
                )
            else:
                break

        self.tile_shape = (tile_h, tile_w)
        self.tile_counts = counts()
        self.scratch_bytes = scratch()

    def _tile_grid(self, h: int, w: int):
        """Reference-shaped tile list [(oh, ow, out_h, out_w)]: output-region
        origin and extent per tile, enumerated exactly like the execute()
        loop of core/unet.cpp:149-186 (interior tiles own tile-2*overlap
        rows/cols; border tiles keep their outer halo as output)."""
        tile_h, tile_w = self.tile_shape
        count_h, count_w = self.tile_counts
        tiles = []
        for i in range(count_h):
            hin = i * (tile_h - 2 * OVERLAP)
            beg_h = OVERLAP if i > 0 else 0
            end_h = OVERLAP if i < count_h - 1 else 0
            th1 = min(h - hin, tile_h)
            out_h = th1 - beg_h - end_h
            for j in range(count_w):
                win = j * (tile_w - 2 * OVERLAP)
                beg_w = OVERLAP if j > 0 else 0
                end_w = OVERLAP if j < count_w - 1 else 0
                tw1 = min(w - win, tile_w)
                out_w = tw1 - beg_w - end_w
                tiles.append((hin + beg_h, win + beg_w, out_h, out_w))
        return tiles

    def _window(self, oh: int, ow: int, h: int, w: int) -> tuple[int, int, int, int]:
        """Input window (ih0, iw0, ih1, iw1) of the tile whose output starts
        at (oh, ow): the overlap around it, clamped to the image, re-anchored
        so that a border tile's window is as large as possible."""
        tile_h, tile_w = self.tile_shape
        ih0 = max(oh - OVERLAP, 0)
        iw0 = max(ow - OVERLAP, 0)
        ih1 = min(ih0 + tile_h, h)
        iw1 = min(iw0 + tile_w, w)
        ih0 = max(min(ih0, ih1 - tile_h), 0)
        iw0 = max(min(iw0, iw1 - tile_w), 0)
        return ih0, iw0, ih1, iw1

    # -- execute ---------------------------------------------------------------
    def execute(self) -> None:
        try:
            with torch.no_grad():
                self._execute_impl()
        except OidnError as e:
            self.device._record_error(e)
            raise

    def _progress(self, done: float) -> None:
        if self.progress_fn is not None:
            if not self.progress_fn(min(max(done, 0.0), 1.0)):
                raise OidnError(OidnError.CANCELLED, "execution was cancelled")

    def _execute_impl(self) -> None:
        if self.dirty or not self._committed:
            self._commit_impl()
        output = self.images["output"]
        h, w = output.shape[:2]
        self._progress(0.0)
        if h == 0 or w == 0:
            self._progress(1.0)
            return

        # input scale: user inputScale, else autoexposure for HDR
        # (unet.cpp:134-144); a float32 scalar made on the device either way
        # (torch.full: a fill, no copy from the host).
        dev = self.device.torch_device
        scale = self.params["inputScale"]
        if isinstance(scale, float) and math.isnan(scale):
            scale = 1.0
            if self.params["hdr"] and self.images["color"] is not None:
                scale = color_mod.autoexposure(_device_f32(self.images["color"], dev))
        if not isinstance(scale, torch.Tensor):
            scale = torch.full((), float(scale), dtype=torch.float32, device=dev)
        transfer = color_mod.make_transfer(self._transfer_kind(), scale)

        if self.progress_fn is None:
            self._execute_device(h, w, transfer)
            return

        tiles = self._tile_grid(h, w)
        n_tiles = len(tiles)
        # Monitored path with DeviceBuffers: per-tile progress goes through
        # the host anyway, so resident inputs come to the host once and the
        # tiles write a host canvas; an output DeviceBuffer gets the
        # stitched result at the end.
        host_images = None
        if any(isinstance(i, DeviceBuffer) for i in self.images.values() if i is not None):
            host_images = {n: i.numpy() if isinstance(i, DeviceBuffer) else i
                           for n, i in self.images.items()}
        # In-place + tiled: later tiles must read input pixels the earlier
        # tiles would have overwritten, so writes go through a temp copied
        # once at the end, the outputTemp/outputCopy path of
        # core/unet.cpp:455-460,187-189. A single tile writes directly: it
        # reads its whole window before writing.
        dest = host_images["output"] if host_images is not None else output
        if self._output_aliases_input() and n_tiles > 1:
            dest = np.zeros((h, w) + output.shape[2:],
                            np.float32 if host_images is not None else output.dtype)
        done = 0
        for oh, ow, out_h, out_w in tiles:
            self._run_tile(oh, ow, out_h, out_w, h, w, transfer, dest,
                           images=host_images)
            done += 1
            self._progress(done / n_tiles)
        if host_images is not None:
            if isinstance(output, DeviceBuffer):
                output.array.copy_(torch.from_numpy(dest))
            elif dest is not host_images["output"]:
                output[...] = dest
        elif dest is not output:
            output[...] = dest  # outputCopy (unet.cpp:187-189)
        self._progress(1.0)

    def _stacked_inputs(self) -> tuple[tuple[str, ...], torch.Tensor]:
        """(names, [h, w, C] float32 stack on the device) of the present
        input images: host arrays upload once each, DeviceBuffers stay."""
        imgs = [(n, self.images.get(n)) for n in ("color", "albedo", "normal")]
        imgs = [(n, i) for n, i in imgs if i is not None]
        dev = self.device.torch_device
        return (tuple(n for n, _ in imgs),
                torch.cat([_device_f32(i, dev) for _, i in imgs], dim=-1))

    def _execute_device(self, h: int, w: int, transfer) -> None:
        """Single-pass tiled execute: the inputs on the device, tiles sliced
        and stitched there in _tile_grid's order, one copy back (none for a
        DeviceBuffer output). Windows, zero fill and output ownership are
        the monitored path's (_run_tile), so a progress monitor does not
        change the pixels; each tile writes exactly the region it owns, so
        every output pixel has one writer. In place needs no outputTemp:
        every input is copied into the stack before the one write."""
        output = self.images["output"]
        names, stacked = self._stacked_inputs()
        tile_h, tile_w = self.tile_shape

        if tile_h >= round_up(h, UNET_ALIGNMENT) and tile_w >= round_up(w, UNET_ALIGNMENT):
            # Single tile: the whole image is the window (the pipeline pads
            # the packed input to the alignment).
            self._write_output(output, self._tile_pipeline(names, stacked, transfer))
            self._progress(1.0)
            return

        # Multi-tile: windows are sliced from a zero-padded copy; the zero
        # fill is only ever the alignment band beyond the image, as in
        # _run_tile's zeroed window array.
        padded = torch.zeros((max(h, tile_h), max(w, tile_w), stacked.shape[-1]),
                             dtype=torch.float32, device=stacked.device)
        padded[:h, :w] = stacked
        mesh = self.params.get("mesh")
        if mesh is not None:
            out = self._execute_mesh(mesh, names, padded, h, w, transfer)
        else:
            out = torch.empty((h, w, 3), dtype=torch.float32, device=stacked.device)
            for oh, ow, th, tw in self._tile_grid(h, w):
                ih0, iw0, _, _ = self._window(oh, ow, h, w)
                y = self._tile_pipeline(names, padded[ih0:ih0 + tile_h, iw0:iw0 + tile_w],
                                        transfer)
                out[oh:oh + th, ow:ow + tw] = y[oh - ih0:oh - ih0 + th, ow - iw0:ow - iw0 + tw]
        self._write_output(output, out)
        self._progress(1.0)

    def _execute_mesh(self, mesh: Mesh, names, padded: torch.Tensor, h: int, w: int,
                      transfer) -> torch.Tensor:
        """The tile table sharded over ``mesh`` (JAX ``_grid_pipeline`` with
        a mesh): padded to a multiple of its size with no-op rows (th = tw =
        0), device d runs rows [d*R/D, (d+1)*R/D) of it on its own copy of
        the inputs and the U-Net into a private zeroed canvas, and the
        canvases are summed onto the filter's device in device order. The
        devices' tiles are issued in turn, so their launches overlap."""
        tile_h, tile_w = self.tile_shape
        table = [(oh, ow, th, tw, *self._window(oh, ow, h, w)[:2])
                 for oh, ow, th, tw in self._tile_grid(h, w)]
        table += [(0, 0, 0, 0, 0, 0)] * (-len(table) % mesh.size)
        per = len(table) // mesh.size
        inputs = [padded.to(d) for d in mesh.devices]
        transfers = [color_mod.make_transfer(transfer.kind, transfer.input_scale.to(d))
                     for d in mesh.devices]
        canvases = [torch.zeros((h, w, 3), dtype=torch.float32, device=d) for d in mesh.devices]
        for k in range(per):
            for d, device in enumerate(mesh.devices):
                oh, ow, th, tw, ih0, iw0 = table[d * per + k]
                if th == 0 or tw == 0:
                    continue  # a padding row writes nothing
                y = self._tile_pipeline(names, inputs[d][ih0:ih0 + tile_h, iw0:iw0 + tile_w],
                                        transfers[d], net=self._network_on(device))
                canvases[d][oh:oh + th, ow:ow + tw] = \
                    y[oh - ih0:oh - ih0 + th, ow - iw0:ow - iw0 + tw]
        return sum_onto(canvases, padded.device)

    @staticmethod
    def _write_output(output, out: torch.Tensor) -> None:
        """Deliver a device result: into a DeviceBuffer on the device (no
        readback); into a host array (or strided view) with one copy."""
        if isinstance(output, DeviceBuffer):
            output.array.copy_(out)
        else:
            output[...] = out.cpu().numpy()

    def _run_tile(self, oh, ow, out_h, out_w, h, w, transfer, output,
                  images=None) -> None:
        """Denoise one tile; write its [oh:oh+out_h, ow:ow+out_w] output
        region (the reference's outputReorder->setTile, unet.cpp:168-176).
        ``images`` overrides self.images (host copies of DeviceBuffer inputs
        on the monitored path)."""
        if images is None:
            images = self.images
        tile_h, tile_w = self.tile_shape
        ih0, iw0, ih1, iw1 = self._window(oh, ow, h, w)

        planes = []
        for name in ("color", "albedo", "normal"):
            img = images.get(name)
            if img is None:
                continue
            window = np.zeros((tile_h, tile_w, 3), np.float32)
            window[: ih1 - ih0, : iw1 - iw0] = img[ih0:ih1, iw0:iw1]
            planes.append((name, window))
        names = tuple(name for name, _ in planes)
        stacked = torch.from_numpy(np.concatenate([wdw for _, wdw in planes], axis=-1))
        out_np = self._tile_pipeline(
            names, stacked.to(self.device.torch_device), transfer).cpu().numpy()

        # This tile's output region inside the computed window.
        vh0 = oh - ih0
        vw0 = ow - iw0
        vh1 = min(vh0 + out_h, ih1 - ih0)
        vw1 = min(vw0 + out_w, iw1 - iw0)
        output[oh : oh + (vh1 - vh0), ow : ow + (vw1 - vw0)] = out_np[vh0:vh1, vw0:vw1]

    def _network_dtype(self) -> torch.dtype:
        """bfloat16 on CUDA, float32 on the CPU (denoise/unet.py net_dtype)."""
        return net_dtype(self.device.torch_device)

    def _network(self) -> UNet:
        """The committed weights on the device in the network's number
        format, cast once per change of weights or format."""
        dtype = self._network_dtype()
        if self._net is None or self._net.convs["enc_conv0"].weight.dtype != dtype:
            with named_scope("mygpurt.filter.build"):
                self._net = UNet.from_tza(self._tensors).to(
                    device=self.device.torch_device, dtype=dtype).eval()
        return self._net

    def _network_on(self, device: torch.device) -> UNet:
        """The committed network on ``device``: the filter's own there, else
        a copy made once per change of weights (a mesh device)."""
        if device == self.device.torch_device:
            return self._network()
        net = self._mesh_nets.get(device)
        if net is None:
            net = self._mesh_nets[device] = copy.deepcopy(self._network()).to(device)
        return net

    def _tile_pipeline(self, names, stacked: torch.Tensor, transfer,
                       net: UNet | None = None) -> torch.Tensor:
        """pack -> pad to the alignment -> U-Net -> unpack for one window
        ``stacked`` [th, tw, C] float32 on the device of ``net`` (default:
        the filter's network); returns [th, tw, 3]."""
        hdr = bool(self.params["hdr"])
        snorm = self._snorm()
        has_color = self.images["color"] is not None
        net = self._network() if net is None else net
        x = _pack_input(names, stacked, transfer, hdr, snorm, has_color)
        th, tw = x.shape[0], x.shape[1]
        hp = round_up(max(th, 1), UNET_ALIGNMENT)
        wp = round_up(max(tw, 1), UNET_ALIGNMENT)
        xp = torch.zeros((1, x.shape[2], hp, wp), dtype=self._network_dtype(), device=x.device)
        xp[0, :, :th, :tw] = x.permute(2, 0, 1)
        with no_tf32():
            y = net(xp)[0, :, :th, :tw].permute(1, 2, 0).float()
        return _unpack_output(y, transfer, hdr, snorm)


def _device_f32(img, dev: torch.device) -> torch.Tensor:
    """An attached image as an [h, w, 3] float32 tensor on ``dev``: a
    DeviceBuffer's own tensor (converted if Half3), a host array uploaded."""
    if isinstance(img, DeviceBuffer):
        return img.array.float()
    return torch.from_numpy(np.ascontiguousarray(img)).to(dev).float()


def _pack_input(names, stacked, transfer, hdr, snorm, has_color):
    """Input packing + sanitize (core/input_reorder.ispc:28-151)."""
    chans = []
    idx = 0
    for name in names:
        v = stacked[..., idx : idx + 3]
        idx += 3
        if name == "color":
            v = v * transfer.input_scale
            v = color_mod.sanitize(v, -1.0 if snorm else 0.0, math.inf if hdr else 1.0)
            if snorm:
                v = v * 0.5 + 0.5
            v = transfer.forward(v)
        elif name == "albedo":
            if not has_color:
                v = v * transfer.input_scale
            v = color_mod.sanitize(v, 0.0, 1.0)
            if not has_color:
                v = transfer.forward(v)
        elif name == "normal":
            if not has_color:
                v = v * transfer.input_scale
            v = color_mod.sanitize(v, -1.0, 1.0)
            v = v * 0.5 + 0.5
        chans.append(v)
    return torch.cat(chans, dim=-1)


def _unpack_output(y, transfer, hdr, snorm):
    """Output sanitize + inverse transfer (core/output_reorder.ispc:26-61)."""
    v = color_mod.sanitize(y, 0.0, math.inf)
    v = transfer.inverse(v)
    if snorm:
        v = torch.clamp_min(v * 2.0 - 1.0, -1.0)
    if not hdr:
        v = torch.clamp_max(v, 1.0)
    return v * transfer.output_scale


class RTFilter(Filter):
    """The "RT" ray-tracing denoiser (core/unet.cpp:613-687)."""

    def _select_weights_name(self) -> str:
        color, albedo, normal = self._features()
        hdr = bool(self.params["hdr"])
        clean = bool(self.params["cleanAux"])
        if color:
            if not albedo and not normal:
                return "rt_hdr" if hdr else "rt_ldr"
            if albedo and not normal:
                return "rt_hdr_alb" if hdr else "rt_ldr_alb"
            if albedo and normal:
                if clean:
                    return "rt_hdr_calb_cnrm" if hdr else "rt_ldr_calb_cnrm"
                return "rt_hdr_alb_nrm" if hdr else "rt_ldr_alb_nrm"
            raise OidnError(
                OidnError.INVALID_OPERATION, "invalid combination of input features"
            )
        if albedo and not normal:
            if hdr:
                raise OidnError(
                    OidnError.INVALID_OPERATION,
                    "hdr mode is not supported for albedo filtering",
                )
            return "rt_alb"
        if normal and not albedo:
            if hdr or self.params["srgb"]:
                raise OidnError(
                    OidnError.INVALID_OPERATION,
                    "hdr and srgb modes are not supported for normal filtering",
                )
            return "rt_nrm"
        raise OidnError(
            OidnError.INVALID_OPERATION, "invalid combination of input features"
        )

    def _transfer_kind(self) -> str:
        # unet.cpp:613-621
        color, _, normal = self._features()
        if self.params["srgb"] or (not color and normal):
            return "linear"
        if self.params["hdr"]:
            return "pu"
        return "srgb"

    def _snorm(self) -> bool:
        color, _, normal = self._features()
        return not color and normal


class RTLightmapFilter(Filter):
    """The "RTLightmap" filter (core/unet.cpp:693-763): hdr -> Log transfer;
    directional -> snorm linear."""

    _image_slots = ("color", "output")

    def __init__(self, device: Device):
        super().__init__(device)
        self.params["hdr"] = True

    def set(self, name, value):
        if name == "directional":
            self.params["directional"] = bool(value)
            self.params["hdr"] = not bool(value)
            self.dirty = True
            return
        super().set(name, value)

    def _features(self):
        return (self.images["color"] is not None, False, False)

    def _select_weights_name(self) -> str:
        if self.images["color"] is None:
            raise OidnError(OidnError.INVALID_OPERATION, "color image not set")
        return "rtlightmap_dir" if self.params["directional"] else "rtlightmap_hdr"

    def _transfer_kind(self) -> str:
        return "linear" if self.params["directional"] else "log"

    def _snorm(self) -> bool:
        return bool(self.params["directional"])
