"""One run of the benchmark's four-rank stage-2 training cell shrunk to
two gloo ranks on the CPU (2 images of 32 px a rank), for
`tests/test_torch_port_stage2_group.py`:

    python tests/torch_port_stage2_group_run.py sound|unaveraged|killed

prints the run's result line as JSON (`sound`; `unaveraged` with rank
0's gradients left out of the group's average), or kills rank 1 at the
group's second step, the window's first (`killed`), after which the run
must end with a non-zero exit and no result. A script of its own: the
group's ranks are started with `spawn` and a lost rank ends the whole
process."""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {'traffic': {'ranks': 2, 'batches': {'batch': 2, 'size': [32, 32],
                                             'count': 2}}}


def main(mode):
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)
    from portbench import harness
    from portbench.families import stage2_group as G
    if mode == 'unaveraged':
        import sc2bench_tpu_torch.train.optim as optim
        average = optim.average_gradients

        def leave_mine_out(params):
            for p in params:
                if p.grad is not None:
                    p.grad.zero_()
            average(params)
        optim.average_gradients = leave_mine_out
    elif mode == 'killed':
        step = G.GroupTrainer.step

        def killing(self, i):
            if i == 1:
                self.workers[0].kill()
            return step(self, i)
        G.GroupTrainer.step = killing
    seconds = 3.0 if mode == 'killed' else 0.3
    result = harness.run_cell('r50fp24-train-stage2-dp4', 2 ** 31 + 5,
                              seconds, 0, 'cpu', time.perf_counter(),
                              overrides=SMALL)
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main(sys.argv[1])
