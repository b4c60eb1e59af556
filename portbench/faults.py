"""Faults planted in the program underneath a run, for the tests that see
`correct` come out false and for the readings that set an upper limit
(`calibrate.py --fault`). Each breaks the timed path where it produces
its result; none is reachable from `run.py`.

    answer_altered   serving: one logit of the first image of each decoded
                     batch moved by 1
    half_batch       serving: the second half of each decoded batch
                     replaced by the first half; training: the step sees
                     the first half of its batch only (the losses' mean
                     and sums taken over the rest)
    state_unchanged  training: the optimizer step leaves every parameter
                     as it was
    state_unchanged_once_warm
                     training: the same from the fourth step on, after
                     the steps that set-up drives
"""
from __future__ import annotations


def plant(name):
    """Patch the program's classes; returns a function that undoes it."""
    undo = []

    def patch(owner, attr, make):
        fn = getattr(owner, attr)
        setattr(owner, attr, make(fn))
        undo.append(lambda: setattr(owner, attr, fn))

    from sc2bench_tpu_torch.models.detection.wrapper import \
        SplitDetectionRuntime
    from sc2bench_tpu_torch.models.runtime import SplitClassifierRuntime
    from sc2bench_tpu_torch.train.box import DistillationBox
    from sc2bench_tpu_torch.train.optim import StageOptimizer
    if name == 'answer_altered':
        def make(fn):
            def altered(self, flat, shape, input_hw=None, module=None):
                out = fn(self, flat, shape, input_hw, module)
                if isinstance(out, dict):
                    out = dict(out)
                    key = 'scores' if 'scores' in out else next(iter(out))
                    out[key] = out[key].clone()
                    out[key].view(-1)[0] += 1.0
                    return out
                out = out.clone()
                out[0, 0] += 1.0
                return out
            return altered
        patch(SplitClassifierRuntime, '_decode_tail', make)
        patch(SplitDetectionRuntime, '_decode_tail', make)
    elif name == 'half_batch':
        def make_serve(fn):
            def halved(self, flat, shape, input_hw=None, module=None):
                k = flat.reshape(-1, flat.shape[-1]).shape[0]
                if k > 1:
                    flat = flat.reshape(k, -1).clone()
                    h = k // 2
                    flat[h:2 * h] = flat[:h]
                return fn(self, flat, shape, input_hw, module)
            return halved

        def make_train(fn):
            def halved(self, x, y):
                h = x.shape[0] // 2
                return fn(self, x[:h], None if y is None else y[:h])
            return halved
        patch(SplitClassifierRuntime, '_decode_tail', make_serve)
        patch(DistillationBox, 'train_step', make_train)
    elif name == 'state_unchanged':
        patch(StageOptimizer, 'step', lambda fn: lambda self: None)
    elif name == 'state_unchanged_once_warm':
        def make(fn):
            calls = [0]

            def cold_only(self):
                calls[0] += 1
                return fn(self) if calls[0] <= 3 else None
            return cold_only
        patch(StageOptimizer, 'step', make)
    else:
        raise KeyError(f'unknown fault {name!r}')

    def restore():
        for u in reversed(undo):
            u()
    return restore
