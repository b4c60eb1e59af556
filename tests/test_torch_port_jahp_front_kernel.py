"""The joint autoregressive codec's front kernels (`csrc/jahp_front.cu`,
`models/zoo_jahp_front.py`) and the loops' choice between them and their
plain version, `ContextModel.front_params`.

On the CPU (codec n=8, m=12, weights drawn by the benchmark's rule): how
a front splits into launches, the loops' plain path, the loops' fused
path with a plain stand-in of the kernels' interface (the same wire and
latent as the plain path, and the counter `codec.fused_fronts`), also on
a latent whose fronts are wider than a launch, and the benchmark's reader
`fused_front_share.jahp`.

On a card (`-m cuda`, about a minute; this file imports neither JAX nor
`sc2bench_tpu`) at quality 8's widths (n=192, m=320): each front against
`front_params` teacher-forced on one latent (scales and means within
1e-5 of the largest magnitude, float32 in another order; rows and
symbols equal but on a table or rounding boundary), the scan's epilogue
against the decoder's, the round trip through the masked lanes on five
latent shapes (one with fronts of 10 positions, two launches a layer),
the graph replays and the launches a front.
"""
import torch_port_threads  # noqa: F401  (pins torch threads)
import pytest
import torch

from portbench import harness
from portbench.reference import jahp as J
from portbench.weights import load_into, make_state
from sc2bench_tpu_torch.models import zoo_jahp_front
from sc2bench_tpu_torch.models.zoo_jahp import (ContextModel,
                                                JointAutoregressiveCodec,
                                                JointAutoregressiveRuntime,
                                                scale_indexes)
from sc2bench_tpu_torch.ops.rans import kernels
from sc2bench_tpu_torch.utils import profiling
from sc2bench_tpu_torch.utils.profiling import recorder, trace

N, M = 8, 12
TOL = 1e-5
# the share of rows and symbols that may sit on a table or rounding
# boundary where the kernels' float32 order and the plain one's differ
BOUNDARY_SHARE = 1e-4


def _runtime(n, m, device, seed=2 ** 31 + 3, hw=(64, 64)):
    dev = torch.device(device)
    sd = J.codec_state(make_state(J.codec_specs(n, m), seed, dev), m)
    g = torch.Generator(device=dev).manual_seed(3)
    J.spread_scales(sd, m, torch.rand((1, 3, *hw), generator=g, device=dev))
    module = load_into(JointAutoregressiveCodec(n=n, m=m).to(dev), sd)
    rt = JointAutoregressiveRuntime(module, device=dev)
    rt.update()
    return rt


def _image(hw, device, seed=9):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((1, 3, *hw), generator=g).to(device)


# ---- the CPU ----------------------------------------------------------------

@pytest.mark.parametrize('slots, want', [
    (1, [(0, 1)]), (6, [(0, 6)]), (8, [(0, 8)]), (9, [(0, 8), (8, 1)]),
    (10, [(0, 8), (8, 2)]), (16, [(0, 8), (8, 8)]),
    (17, [(0, 8), (8, 8), (16, 1)]), (30, [(0, 8), (8, 8), (16, 8), (24, 6)])])
def test_a_front_launches_in_groups_of_at_most_max_slots_rows(slots, want):
    assert zoo_jahp_front.groups(slots) == want
    assert all(n <= zoo_jahp_front.MAX_SLOTS for _, n in want)


class _Calls:
    """Counts the calls of `ContextModel.front_params`."""

    def __init__(self, monkeypatch):
        self.n = 0
        plain = ContextModel.front_params

        def counted(ctx, *args):
            self.n += 1
            return plain(ctx, *args)
        monkeypatch.setattr(ContextModel, 'front_params', counted)


def test_on_the_cpu_the_loops_run_front_params(monkeypatch, tmp_path):
    rt = _runtime(N, M, 'cpu')
    assert rt._front_kernels is None
    calls = _Calls(monkeypatch)
    x = _image((64, 64), 'cpu')
    with trace(str(tmp_path)):
        latent, valid = rt.decode_device_latent(rt.encode_device_wire(x))
        s = recorder.summarize()
    steps = rt.schedule(4, 4).steps
    assert bool(valid) and calls.n == 2 * steps
    assert s['codec.front_steps']['count'] == 2 * steps
    assert 'codec.fused_fronts' not in s


class _PlainFronts:
    """`FrontKernels`' interface in plain PyTorch on the CPU, from the
    runtime's `ContextModel`: it drives the loops' fused path here."""

    def __init__(self, rt):
        self.rt, self.m, self.calls = rt, rt.module.m, 0

    def _params(self, y_hat, hyper, sch, t):
        self.calls += 1
        return self.rt.context.front_params(y_hat, hyper, sch.ii[t],
                                            sch.jj[t])

    def scan(self, y, hyper, sch, y_hat):
        syms, idxs = [], []
        for t in range(sch.steps):
            scales, means = self._params(y_hat, hyper, sch, t)
            sym = torch.round(y[sch.ii[t].clamp_min(0), sch.jj[t]] - means)
            sch.write(y_hat, t, sym + means)
            syms.append(sym.to(torch.int32))
            idxs.append(scale_indexes(scales, self.rt._scale_table))
        return torch.stack(syms), torch.stack(idxs), y_hat

    def front(self, y_hat, hyper, sch, t):
        s, mu = self._params(y_hat, hyper, sch, t)
        return mu, scale_indexes(s, self.rt._scale_table).reshape(-1)

    def write(self, y_hat, sch, t, sym, means):
        sch.write(y_hat, t, sym.reshape(-1, self.m).to(torch.float32)
                  + means)


def test_the_fused_path_gives_the_plain_paths_wire_and_latent(tmp_path):
    """The loops' fused path (a plain stand-in of the kernels) against the
    plain path on two images: the same wire, latent and host-wire round
    trip; every front counted in `codec.fused_fronts`."""
    plain, fused = _runtime(N, M, 'cpu'), _runtime(N, M, 'cpu')
    fused._front_kernels = stand_in = _PlainFronts(fused)
    for k, hw in enumerate(((64, 64), (64, 128))):
        x = _image(hw, 'cpu', seed=k)
        with trace(str(tmp_path)):
            got = fused.encode_device_wire(x)
            latent, valid = fused.decode_device_latent(got)
            s = recorder.summarize()
        want = plain.encode_device_wire(x)
        for key in ('y_streams', 'y_states', 'y_lengths', 'nbytes', 'y_hat'):
            assert torch.equal(got[key], want[key]), key
        assert bool(valid) and torch.equal(latent, want['y_hat'])
        steps = fused.schedule(*got['shape']).steps
        assert s['codec.fused_fronts']['count'] == \
            s['codec.front_steps']['count'] == 2 * steps
        comp, y_hat = fused.compress_latent(x)
        assert torch.equal(fused.decompress_latent(**comp), y_hat)
        assert torch.equal(y_hat, want['y_hat'])
    assert stand_in.calls > 0


def test_fronts_wider_than_a_launch_run_through_the_kernels(tmp_path):
    """A 12x28 latent has fronts of 10 positions, wider than a launch's
    `MAX_SLOTS`: the loops still run every front through the kernels (a
    plain stand-in here), with the plain path's wire and latent."""
    plain, rt = _runtime(N, M, 'cpu'), _runtime(N, M, 'cpu')
    rt._front_kernels = stand_in = _PlainFronts(rt)
    x = _image((192, 448), 'cpu')
    with trace(str(tmp_path)):
        got = rt.encode_device_wire(x)
        latent, valid = rt.decode_device_latent(got)
        s = recorder.summarize()
    sch = rt.schedule(12, 28)
    assert sch.slots > zoo_jahp_front.MAX_SLOTS
    assert bool(valid) and stand_in.calls == 2 * sch.steps
    assert s['codec.fused_fronts']['count'] == \
        s['codec.front_steps']['count'] == 2 * sch.steps
    want = plain.encode_device_wire(x)
    for key in ('y_streams', 'y_states', 'y_lengths', 'nbytes', 'y_hat'):
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(latent, want['y_hat'])


class _Recorder:
    def __init__(self, summary):
        self.summary = summary

    def summarize(self):
        return self.summary


@pytest.mark.parametrize('summary, traced, want', [
    ({'codec.front_steps': {'count': 244},
      'codec.fused_fronts': {'count': 244}}, True, 100.0),
    ({'codec.front_steps': {'count': 244},
      'codec.fused_fronts': {'count': 61}}, True, 25.0),
    ({'codec.front_steps': {'count': 244}}, True, None),
    ({'codec.front_steps': {'count': 244},
      'codec.fused_fronts': {'count': 244}}, False, None),
    ({}, True, None)])
def test_the_fused_front_share_reader(summary, traced, want, monkeypatch):
    monkeypatch.setattr(profiling, 'recorder', _Recorder(summary))
    read = harness.metric_reader('fused_front_share.jahp')
    got = read({'trace': {'busy_s': 1.0} if traced else None,
                'counters': {}, 'system': None})
    assert got == want


# ---- the card -----------------------------------------------------------------

@pytest.fixture(scope='module')
def card_rt():
    if not torch.cuda.is_available():
        pytest.skip('the front kernels run on a card')
    rt = _runtime(192, 320, 'cuda', hw=(256, 320))
    assert rt._front_kernels is not None
    return rt


@torch.no_grad()
def _latents(rt, hw=(256, 448)):
    """y (h, w, m) and hyper (h, w, 2m) of one image on the card: a 16x28
    latent, whose fronts of 10 positions take two launches a layer."""
    y, _, hyper = rt._encode_ops(_image(hw, rt.device))
    return y.contiguous(), hyper


def _plain_scan(rt, y, hyper):
    kept, rt._front_kernels = rt._front_kernels, None
    try:
        return rt._scan_loop(y, hyper)
    finally:
        rt._front_kernels = kept


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
def test_each_front_equals_front_params(card_rt):
    """Teacher-forced on the plain scan's latent, front by front: scales
    and means within 1e-5 of the largest magnitude; rows and symbols equal
    but for at most `BOUNDARY_SHARE` on a boundary, each one step away."""
    rt = card_rt
    y, hyper = _latents(rt)
    _, _, y_hat = _plain_scan(rt, y, hyper)
    sch = rt.schedule(*y.shape[:2])
    fk, m, F = rt._front_kernels, rt.module.m, sch.slots
    scales = torch.empty((F, m), device=rt.device)
    worst, off, total = 0.0, 0, 0
    for t in range(sch.steps):
        n = sch.counts[t]
        s_p, mu_p = rt.context.front_params(y_hat, hyper, sch.ii[t],
                                            sch.jj[t])
        means, idx = fk.front(y_hat, hyper, sch, t, scales=scales)
        worst = max(worst, _rel(scales[:n], s_p[:n]), _rel(means[:n],
                                                          mu_p[:n]))
        yy = y[sch.ii[t, :n], sch.jj[t, :n]]
        for got, want in (
                (idx.reshape(F, m)[:n], scale_indexes(s_p, rt._scale_table)
                 [:n]),
                (torch.round(yy - means[:n]), torch.round(yy - mu_p[:n]))):
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
            assert int(diff.max()) <= 1
            off += int((diff > 0).sum())
            total += diff.numel()
    assert worst <= TOL, worst
    assert off <= BOUNDARY_SHARE * total, (off, total)


@pytest.mark.cuda
def test_the_scans_epilogue_equals_the_decoders(card_rt):
    """The fused scan's symbols, rows and latent against the decoder's
    front (means and rows) teacher-forced on that latent: exactly equal."""
    rt = card_rt
    y, hyper = _latents(rt)
    syms, idxs, y_hat = rt._scan_loop(y, hyper)
    sch = rt.schedule(*y.shape[:2])
    fk, m, F = rt._front_kernels, rt.module.m, sch.slots
    for t in range(sch.steps):
        n = sch.counts[t]
        means, idx = fk.front(y_hat, hyper, sch, t)
        ii, jj = sch.ii[t, :n], sch.jj[t, :n]
        sym = torch.round(y[ii, jj] - means[:n])
        assert torch.equal(syms[t, :n], sym.to(torch.int32))
        assert torch.equal(idxs[t, :n], idx.reshape(F, m)[:n])
        assert torch.equal(y_hat[ii + 2, jj + 2], sym + means[:n])


@pytest.mark.cuda
@pytest.mark.parametrize('h, w', [(4, 4), (14, 14), (16, 16), (15, 17),
                                  (12, 28)])
def test_the_masked_lanes_round_trip_through_the_fused_loops(card_rt, h, w):
    """Scan, `masked_encode_aligned`, the decoder's fused loop: the latent
    bit for bit, every lane back to its initial state, and the launches a
    front exact (a 12x28 latent's fronts of 10 positions launch each
    layer twice)."""
    from sc2bench_tpu_torch.ops.rans.device import RANS_L
    rt = card_rt
    y, hyper = _latents(rt)
    y, hyper = y[:h, :w].contiguous(), hyper[:h, :w].contiguous()
    sch = rt.schedule(h, w)
    kernels.reset_launches()
    syms, idxs, y_hat = rt._scan_loop(y, hyper)
    vc, idx, ok = rt.masked_values(syms, idxs, sch)
    assert bool(ok)
    streams, _, states = kernels.masked_encode_aligned(
        rt._g_tables_dev[0], vc, idx, sch.active, rt.module.m,
        prepared=rt._g_prepared)
    got, x = rt._fronts_loop(sch, streams, states, hyper)
    torch.cuda.synchronize()
    assert torch.equal(got, y_hat)
    assert bool((x == RANS_L).all())
    T, G = sch.steps, len(zoo_jahp_front.groups(sch.slots))
    assert G == (2 if (h, w) == (12, 28) else 1)
    want = {'jahp_front_ctx': 2 * T * G, 'jahp_front_hidden': 4 * T * G,
            'jahp_front_params': 2 * T * G, 'jahp_front_write': T * G,
            'rans_masked_encode_aligned': 1, 'rans_masked_decode_front': T}
    assert dict(kernels.LAUNCHES) == {k: want.get(k, 0)
                                      for k in kernels.ALL_KERNELS}


@pytest.mark.cuda
def test_the_graph_replays_equal_the_eager_loops(card_rt, tmp_path):
    """Four calls of the device wire on one image: the first eager, the
    second captured, the later ones replayed; every call the same wire,
    latent and launches, and every front of a traced replay fused."""
    rt = card_rt
    x = _image((256, 256), rt.device, seed=4)
    calls = []
    for k in range(4):
        kernels.reset_launches()
        ops = rt.encode_device_wire(x)
        latent, valid = rt.decode_device_latent(ops)
        torch.cuda.synchronize()
        calls.append((ops, latent, bool(valid), dict(kernels.LAUNCHES)))
    with trace(str(tmp_path)):
        rt.decode_device_latent(rt.encode_device_wire(x))
        s = recorder.summarize()
    assert s['codec.fused_fronts']['count'] == \
        s['codec.front_steps']['count'] == 2 * rt.schedule(16, 16).steps
    first = calls[0]
    assert first[2] and torch.equal(first[1], first[0]['y_hat'])
    T = rt.schedule(16, 16).steps
    assert first[3]['jahp_front_params'] == 2 * T
    assert first[3]['jahp_front_write'] == T
    for ops, latent, valid, launches in calls[1:]:
        assert valid and launches == first[3]
        assert torch.equal(latent, first[1])
        for k in ('y_streams', 'y_states', 'y_lengths', 'nbytes'):
            assert torch.equal(ops[k], first[0][k]), k
    assert rt._scan_graphs.replays >= 2 and rt._front_graphs.replays >= 2


@pytest.mark.cuda
def test_the_host_wire_takes_the_kernels_both_ways(card_rt):
    rt = card_rt
    x = _image((256, 256), rt.device, seed=5)
    comp, y_hat = rt.compress_latent(x)
    assert torch.equal(rt.decompress_latent(**comp), y_hat)
    assert torch.equal(rt.decode_device_latent(rt.encode_device_wire(x))[0],
                       y_hat)
