"""Probe: do 16-bit 128-wide table rows load, convert and gather faster than
the f32 126-wide rows of the brick table, on this card?

Counterpart of ``scripts/probe_f16.py``. Kernels S4 (:func:`probe_load`, a
(n, 128) block in bf16, f16 or int16 summed over every 16th column) and S5
(:func:`probe_bitcast_i16_bf16`, int16 bit patterns read as bf16) are
hand-written CUDA (``csrc/probe_f16.cu``), each beside its plain-torch twin;
:func:`probe_gathers` times 11 x 2^20 random row gathers (``index_select``)
from a 50*400*400-row table in f32 x 126 and in 16-bit x 128. All arrays are
made on the device. Prints one JSON line per probe:

    python -m raider_tpu_torch.scripts.probe_f16
"""

import json

import torch

from raider_tpu_torch import kernels
from raider_tpu_torch.kernels import PROBE_DTYPES
from raider_tpu_torch.scripts import card, cuda_ms
from raider_tpu_torch.utils import require_device

N = 1 << 20
WIDTH = 128
STRIDE = 16
GATHER_ROWS = 50 * 400 * 400
GATHERS = 11


def make_block(dtype, n: int = N, device='cuda'):
    """(n, WIDTH) block of 100 sin(1e-3 k) in ``dtype`` (int16: x 100, rounded)."""
    v = torch.arange(n * WIDTH, dtype=torch.float32, device=device).reshape(n, WIDTH)
    v = torch.sin(v * 1e-3) * 100.0
    if dtype == torch.int16:
        return torch.round(v * 100.0).to(torch.int16)
    return v.to(dtype)


def probe_load_ref(x):
    """Plain-torch twin of kernel S4: the Pallas loop, column by column."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for r in range(0, WIDTH, STRIDE):
        acc = acc + x[:, r].float() * 0.5
    return acc


def _check_block(name, x, dtypes):
    if x.dim() != 2 or x.shape[1] != WIDTH or x.dtype not in dtypes:
        raise ValueError(f'{name}: needs an (n, {WIDTH}) block of {dtypes}, '
                         f'got {tuple(x.shape)} {x.dtype}')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {x.device}')
    if x.device.type == 'cuda' and not x.is_contiguous():
        raise ValueError(f'{name}: the CUDA kernel takes a contiguous block')


def probe_load(x):
    """Kernel S4: (n,) f32 sums of ``x[:, ::16] * 0.5``. CPU tensors run the
    twin; CUDA tensors launch the kernel."""
    _check_block('probe_load', x, tuple(PROBE_DTYPES.values()))
    if x.device.type == 'cpu':
        return probe_load_ref(x)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    kernels.launch_probe_load(x, out)
    return out


def probe_bitcast_i16_bf16_ref(x):
    """Plain-torch twin of kernel S5."""
    return x.view(torch.bfloat16).float()


def probe_bitcast_i16_bf16(x):
    """Kernel S5: int16 bit patterns read as bf16, as f32. CPU tensors run
    the twin; CUDA tensors launch the kernel."""
    _check_block('probe_bitcast_i16_bf16', x, (torch.int16,))
    if x.device.type == 'cpu':
        return probe_bitcast_i16_bf16_ref(x)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError('probe_bitcast_i16_bf16: the CUDA kernel needs 16-byte aligned rows')
    kernels.launch_probe_bitcast_i16_bf16(x, out)
    return out


def _max_abs(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def probe_gathers(device='cuda', n: int = N, nrows: int = GATHER_ROWS, seed: int = 0):
    """Time GATHERS gathers of ``n`` random rows each, summed per row into an
    f32 accumulator, from an f32 x 126 table and 16-bit x 128 tables.
    Returns one record per table: the fastest of 3 runs, by CUDA events."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, nrows - 1, (GATHERS, n), generator=gen, device=dev)
    records = []
    for name, width, dt in (('f32_126', 126, torch.float32), ('f16_128', 128, torch.float16),
                            ('bf16_128', 128, torch.bfloat16), ('i16_128', 128, torch.int16)):
        tab = torch.arange(nrows * width, dtype=torch.float32, device=dev).reshape(nrows, width)
        tab = torch.sin(tab * 1e-3)
        tab = torch.round(tab * 100.0).to(dt) if dt == torch.int16 else tab.to(dt)

        def gather(tab=tab):
            acc = torch.zeros(n, dtype=torch.float32, device=dev)
            for k in range(GATHERS):
                acc = acc + tab.index_select(0, idx[k]).float().sum(1)
            return acc

        t_s = min(cuda_ms(gather, reps=1) for _ in range(3)) / 1e3
        gb = GATHERS * n * width * tab.element_size() / 1e9
        records.append(dict(gather=name, t_s=t_s, gbytes=gb, gbps=gb / t_s))
        del tab
    return records


def run(device='cuda', n: int = N, gather_rows: int = GATHER_ROWS, say=print):
    """All probes on ``device`` (the card unless the caller names another):
    each kernel against its twin and timed, then the gathers. Prints and
    returns one record per probe."""
    dev = require_device(device)
    timed = dev.type == 'cuda'
    records = []

    def emit(rec):
        records.append(rec)
        say(json.dumps(rec))

    for suffix, dt in PROBE_DTYPES.items():
        x = make_block(dt, n, dev)
        err = _max_abs(probe_load(x), probe_load_ref(x))
        rec = {f'probe_load_{suffix}': True, 'max_abs_err': err}
        if timed:
            rec.update(ms=cuda_ms(lambda: probe_load(x)), plain_ms=cuda_ms(lambda: probe_load_ref(x)))
        emit(rec)
    x = make_block(torch.bfloat16, n, dev).view(torch.int16)
    err = _max_abs(probe_bitcast_i16_bf16(x), probe_bitcast_i16_bf16_ref(x))
    rec = {'bitcast_i16_bf16': True, 'max_abs_err': err}
    if timed:
        rec.update(ms=cuda_ms(lambda: probe_bitcast_i16_bf16(x)),
                   plain_ms=cuda_ms(lambda: probe_bitcast_i16_bf16_ref(x)))
    emit(rec)
    del x
    if timed:
        for rec in probe_gathers(dev, n, gather_rows):
            emit(rec)
    return records


def main() -> None:
    dev = require_device('cuda')
    print(json.dumps(dict(card=card(), torch=torch.__version__, cuda=torch.version.cuda)),
          flush=True)
    run(dev, say=lambda s: print(s, flush=True))


if __name__ == '__main__':
    main()
