"""Host/device dual pixel planes (port of
x265_mod_by_patman_tpu/frame/planes.py).

`DevPlane` is an np.ndarray subclass carrying a per-device cache of its
int32 torch copy, so a source or reference plane that several stages
read (analysis, wavefront, SAO stats, MC of later frames) is uploaded
once.  Views and slices drop the cache."""
from __future__ import annotations

import numpy as np
import torch


class DevPlane(np.ndarray):
    """Host pixel plane with a cached int32 torch copy per device."""

    _devs = None

    def __array_finalize__(self, obj):
        self._devs = None

    def __array_wrap__(self, obj, context=None, return_scalar=False):
        r = obj.view(np.ndarray)
        return r[()] if r.ndim == 0 else r


def as_devplane(a: np.ndarray) -> DevPlane:
    if isinstance(a, DevPlane) and a._devs is not None:
        return a
    v = np.asarray(a).view(DevPlane)
    v._devs = {}
    return v


def attach_dev(host: np.ndarray, dev_arr: torch.Tensor) -> DevPlane:
    """Wrap `host` and seed its cache with `dev_arr` (its int32 copy
    already on a device, e.g. the recon the wavefront just produced)."""
    v = as_devplane(host)
    v._devs[dev_arr.device] = dev_arr
    return v


def pack_levels(ly, lu, lv):
    """int16 level stores plus the per-block nonzero maps."""
    nz = lambda a: (a.reshape(a.shape[0], a.shape[1], -1) != 0).any(-1)
    return (ly.to(torch.int16), lu.to(torch.int16), lv.to(torch.int16),
            nz(ly), nz(lu), nz(lv))


def pack_recon(dy, du, dv, bd: int):
    """Three int32 recon planes -> one flat pixel-width buffer: uint8 at
    8 bits, else int16 (torch's uint16 has few CUDA ops; samples below
    2^12 fit, and the host views the buffer as uint16)."""
    dt = torch.uint8 if bd == 8 else torch.int16
    return torch.cat([dy.reshape(-1), du.reshape(-1),
                      dv.reshape(-1)]).to(dt)


def dev_i32(x, device) -> torch.Tensor:
    """int32 tensor of a plane on `device`, uploading (and caching) at
    most once per device for DevPlanes."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    if isinstance(x, DevPlane) and x._devs is not None:
        key = device if device.index is not None or device.type == "cpu" \
            else torch.device(device.type, torch.cuda.current_device())
        got = x._devs.get(key)
        if got is None:
            host = np.ascontiguousarray(x.view(np.ndarray))
            if host.dtype == np.uint16:
                # torch's uint16 has few CUDA ops: widen on the host
                host = host.astype(np.int32)
            elif not host.flags.writeable:
                # read-only input (a y4m frame read by np.frombuffer):
                # torch.from_numpy wants a writable buffer
                host = host.copy()
            got = torch.from_numpy(host).to(key).to(torch.int32)
            x._devs[key] = got
        return got
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x), dtype=np.int32)).to(device)
