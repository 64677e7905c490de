"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program
(``textgcn_tpu_torch``).  Exits with 2, printing no result, where CUDA
is absent or has fewer cards than the cell asks for, and where the
process holds JAX or the JAX package.  The last line of standard output
is the result as one JSON object; the last lines of standard error are
the numbers compared, each with its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    checkout = os.path.dirname(HERE)
    sys.path.insert(0, checkout)
    # every build cache at a fixed path inside the checkout (the program's
    # own nvcc and c++ libraries go to build/kernels and build/native)
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = os.path.join(checkout, 'build', sub)
    from portbench import harness, isolation
    harness.log(f'portbench: {args.workload} seed {args.seed} '
                f'{args.seconds:g} s trace {args.trace}')
    import torch
    cell = harness.Cell.load(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f'portbench: needs {chips} CUDA device(s), found {found}')
        return 2
    isolation.require_clean('at start')
    import textgcn_tpu_torch  # noqa: F401  the program under test, or fail
    result = harness.run(cell.name, args.seed, args.seconds,
                         bool(args.trace), device='cuda:0', t_start=T_START)
    isolation.require_clean('once the window closed')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
