"""The ``grid_argmin`` op: the fleet table sweep's entry point.

The op follows its inputs' device.  CUDA tensors launch the kernel in
``csrc/grid_argmin.cu`` (built on first use by ``kernels._build``) on the
current stream, without synchronizing; CPU tensors run the plain PyTorch
version in ``ref.py``, which is how a caller asks for the CPU.  There is
no fallback between the two: a CUDA input that the kernel cannot take
raises.  ``grid_argmin.launches`` counts kernel launches.

The kernel takes any grid whose flat indices fit an int32, and sizes its
own launch from the card's SM count (``make_plan`` in the ``.cu``).

The entry reports its work to a running ``analysis.op_cost`` counter on
every route: no products, each input read once and each output written
once.  On a fake tensor it returns empty outputs and runs nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import op_cost
from repro_torch.core import characterization as char
from repro_torch.core import voltage as volt
from repro_torch.kernels import _build
from repro_torch.kernels.grid_argmin.ref import grid_argmin_ref

#: Largest flat grid: every flat index, and one block stride past it, fits an int32.
MAX_FLAT_POINTS = 2**31 - 1 - 1024

_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_kernel_layout(params: char.PlatformParams, masks: torch.Tensor,
                         levels: torch.Tensor, core_grid: torch.Tensor,
                         bram_grid: torch.Tensor) -> None:
    """What the kernel needs beyond dtypes and shapes: non-empty axes, a
    launch grid within CUDA's limits, int32 flat indices and contiguous
    tensors."""
    n_p, n_r = params.watts_scale.shape[0], masks.shape[0]
    m, c, b = levels.shape[-1], core_grid.shape[0], bram_grid.shape[0]
    d, t = params.dl_weight.shape[-1], params.pw_dyn.shape[-1]
    if min(n_p, n_r, m, c, b, d, t) < 1:
        raise ValueError("grid_argmin: every axis must be non-empty")
    if n_p > 65535 or n_r > 65535:
        raise ValueError(f"grid_argmin kernel takes at most 65535 platforms and "
                         f"rows (got {n_p}, {n_r})")
    if c * b > MAX_FLAT_POINTS or max(d, t) >= 2**15:
        raise ValueError(f"grid_argmin kernel: {c * b} grid points or {max(d, t)} "
                         f"terms exceed its int32 indices")
    tensors = {**params._asdict(), "masks": masks, "levels": levels,
               "core_grid": core_grid, "bram_grid": bram_grid}
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"grid_argmin: {name} must be contiguous")


def _check(params: char.PlatformParams, masks: torch.Tensor,
           levels: torch.Tensor, core_grid: torch.Tensor,
           bram_grid: torch.Tensor) -> torch.device:
    """Validate device, dtype and shape; return the common device."""
    tensors = {**params._asdict(), "masks": masks, "levels": levels,
               "core_grid": core_grid, "bram_grid": bram_grid}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"grid_argmin inputs span devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"grid_argmin runs on 'cuda' or 'cpu', not {dev}")
    for name, t in tensors.items():
        want = (torch.int32 if name in char.INT_FIELDS else
                torch.bool if name == "masks" else torch.float32)
        if t.dtype != want:
            raise TypeError(f"grid_argmin: {name} is {t.dtype}, want {want}")
    n_p, n_r = params.watts_scale.shape[0], masks.shape[0]
    c, b = core_grid.shape[0], bram_grid.shape[0]
    shapes = {"masks": (n_r, c, b), "levels": (n_r, levels.shape[-1]),
              "core_grid": (c,), "bram_grid": (b,), "delay_mode": (n_p,),
              "nominal_power_arb": (n_p,), "watts_scale": (n_p,)}
    for name in ("dl_weight", "dl_vth", "dl_alpha", "dl_v0", "dl_rail"):
        shapes[name] = (n_p, params.dl_weight.shape[-1])
    for name in ("pw_rail", "pw_v0", "pw_dyn", "pw_stat", "pw_kappa"):
        shapes[name] = (n_p, params.pw_dyn.shape[-1])
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"grid_argmin: {name} has shape "
                             f"{tuple(tensors[name].shape)}, want {shape}")
    return dev


def grid_argmin(params: char.PlatformParams, masks: torch.Tensor,
                levels: torch.Tensor, core_grid: torch.Tensor,
                bram_grid: torch.Tensor, *,
                slack_eps: float = 1e-6) -> volt.OperatingPoint:
    """Fused masked grid sweep + per-bin argmin over a stacked fleet.

    ``params`` leaves ``[P, ...]``; ``masks`` ``[R, C, B]`` bool (one row
    per DVFS technique / hybrid gear); ``levels`` ``[R, M]`` float32;
    ``core_grid``/``bram_grid`` the shared ascending grids.  Returns an
    :class:`~repro_torch.core.voltage.OperatingPoint` with ``[P, R, M]``
    fields: the first flat-index minimum among feasible points, or the
    nominal corner when none is feasible.
    """
    dev = _check(params, masks, levels, core_grid, bram_grid)
    n_p, (n_r, m) = params.watts_scale.shape[0], levels.shape
    # v_core, v_bram, power (fp32) and feasible (bool) of [P, R, M]
    ins = (*params, masks, levels, core_grid, bram_grid)
    work = lambda: (0.0, op_cost.tensor_bytes(*ins) + 13.0 * n_p * n_r * m, 0.0)
    with op_cost.kernel("grid_argmin", work):
        if op_cost.is_fake(masks):
            _check_kernel_layout(params, masks, levels, core_grid, bram_grid)
            out = [torch.empty((n_p, n_r, m), dtype=torch.float32, device=dev)
                   for _ in range(3)]
            return volt.OperatingPoint(
                v_core=out[0], v_bram=out[1], f_rel=levels[None].expand(n_p, n_r, m),
                power=out[2], feasible=torch.empty((n_p, n_r, m), dtype=torch.bool,
                                                   device=dev))
        if dev.type == "cpu":
            return grid_argmin_ref(params, masks, levels, core_grid, bram_grid,
                                   slack_eps=slack_eps)
        return _launch(params, masks, levels, core_grid, bram_grid, slack_eps)


def _launch(params, masks, levels, core_grid, bram_grid, slack_eps):
    dev = masks.device
    _check_kernel_layout(params, masks, levels, core_grid, bram_grid)
    fn = _build.load("grid_argmin").grid_argmin_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    n_p, (n_r, m) = params.watts_scale.shape[0], levels.shape
    c, b = core_grid.shape[0], bram_grid.shape[0]
    v_core, v_bram, power = (torch.empty((n_p, n_r, m), dtype=torch.float32,
                                         device=dev) for _ in range(3))
    feasible = torch.empty((n_p, n_r, m), dtype=torch.bool, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in params[:11]], masks.data_ptr(),
                levels.data_ptr(), core_grid.data_ptr(), bram_grid.data_ptr(),
                v_core.data_ptr(), v_bram.data_ptr(), power.data_ptr(),
                feasible.data_ptr(), n_p, n_r, m, c, b,
                params.dl_weight.shape[-1], params.pw_dyn.shape[-1],
                1.0 + slack_eps, sms, stream)
    if rc != 0:
        raise RuntimeError(f"grid_argmin kernel launch failed: CUDA error {rc}")
    grid_argmin.launches += 1
    return volt.OperatingPoint(v_core=v_core, v_bram=v_bram,
                               f_rel=levels[None].expand(n_p, n_r, m),
                               power=power, feasible=feasible)


grid_argmin.launches = 0
