"""Holdout-seed evaluation sweep (port of ``tools/holdout_sweep.py``): the
registration benchmark (``cli.benchmark -e``) over N evaluation-warp seeds,
each seed's metrics and a mean ± 95% CI summary.

    python -m xpoint_tpu_torch.tools.holdout_sweep --work WORK_DIR \\
        [--model WORK_DIR/pair-train] [--seeds 10] [--out WORK_DIR/holdout]

The seeds draw the evaluation warps of one trained model (seed 0 is the
cycle's own draw); they are not training seeds. The eval YAML is the one
the cycle wrote (``<work>/eval.yaml``). Each seed runs ``python -m
xpoint_tpu_torch.cli.benchmark -e -s SEED`` in a process of its own, or all
in this process with ``--one-process`` (the model loaded once; the same
numbers). A seed whose output JSON exists is not evaluated again. The
summary (``summary.json``) has the keys of the JAX tool's. ``--out``
defaults to ``<work>/holdout``, not the JAX side's committed
``metrics/holdout``. Runs on the card unless ``--device`` says otherwise.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SUMMARY_KEYS = ('h_correctness@3', 'nn_map@3', 'm_score@3',
                'repeatability@3', 'avg_h_error')


def mean_ci(xs):
    n = len(xs)
    m = sum(xs) / n
    if n < 2:
        return m, 0.0
    var = sum((x - m) ** 2 for x in xs) / (n - 1)
    # 95% CI with Student's t for small n (normal beyond 10)
    t = {2: 12.71, 3: 4.30, 4: 3.18, 5: 2.78, 6: 2.57, 7: 2.45, 8: 2.36,
         9: 2.31, 10: 2.26}.get(n, 1.96)
    return m, t * math.sqrt(var / n)


def run_seed_inprocess(state, seed, eval_yaml, model, odir, device):
    """Evaluate one seed in this process, the model loaded once for the
    sweep: ``cli.benchmark -e -s SEED``'s seeds -> dataset -> timing
    harness draws -> metric loop, with only the model set-up hoisted out
    of the loop (it draws from no global stream)."""
    import numpy as np

    from ..cli._common import load_eval_setup, seeded_dataset, set_seeds
    from ..data import DataLoader
    from ..eval.benchmark import compute_metrics, timing_harness

    if state.get('infer') is None:
        from types import SimpleNamespace
        set_seeds(seed)
        ns = SimpleNamespace(yaml_config=eval_yaml, model_dir=model,
                             version='latest', yaml_variable=None,
                             device=device)
        state['config'], _, state['infer'], _ = load_eval_setup(
            ns, single_image_override=False)
    config, infer = state['config'], state['infer']
    set_seeds(seed)
    dataset = seeded_dataset(config['dataset'], seed)
    rng = np.random.default_rng(seed)
    indices = sorted(rng.choice(len(dataset), size=min(5, len(dataset)),
                                replace=False).tolist())
    times = timing_harness(infer, dataset, indices, config)
    loader = DataLoader(dataset, batch_size=1, shuffle=False)
    results = compute_metrics(
        infer, loader, config,
        threshold_repeatability=list(range(1, 11)),
        threshold_keypoints=list(range(1, 11)),
        threshold_warp=list(range(1, 11)),
        threshold_ransac=[2])
    results['timing_seconds'] = {k: list(map(float, v))
                                 for k, v in times.items()}
    os.makedirs(odir, exist_ok=True)
    out_path = os.path.join(
        odir, f"benchmark_{os.path.basename(model)}_latest_s{seed}.json")
    with open(out_path, 'w') as f:
        json.dump(results, f, indent=2, default=float)
    print(f"results written to {out_path}", flush=True)


def seed_metrics(res):
    """The five summary metrics of one benchmark JSON."""
    d3 = res['descriptor']['3']
    h = res['homography'][sorted(res['homography'])[0]]
    return {
        'h_correctness@3': h['h_correctness']['epsilon_warp_th3'],
        'avg_h_error': h['average_h_error'],
        'nn_map@3': d3['nn_map'],
        'm_score@3': d3['m_score'],
        'repeatability@3': res['repeatability']['3'],
    }


def summarize(per_seed):
    summary = {'n_seeds': len(per_seed), 'per_seed': per_seed}
    for key in SUMMARY_KEYS:
        xs = [per_seed[s][key] for s in per_seed]
        m, ci = mean_ci(xs)
        summary[key] = {'mean': m, 'ci95': ci, 'min': min(xs),
                        'max': max(xs)}
    return summary


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--work',
                    default=os.path.join(tempfile.gettempdir(), 'cycle'))
    ap.add_argument('--model', default=None,
                    help='model dir (default {work}/pair-train)')
    ap.add_argument('--eval-yaml', default=None,
                    help='eval config (default {work}/eval.yaml)')
    ap.add_argument('--seeds', type=int, default=10)
    ap.add_argument('--out', default=None,
                    help='output dir (default {work}/holdout)')
    ap.add_argument('--one-process', action='store_true',
                    help='run all seeds in this process (model built once) '
                         'instead of one cli.benchmark process per seed — '
                         'same numbers')
    ap.add_argument('--device', default='cuda',
                    help='torch device of the model (default: cuda)')
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the sweep; returns the summary written to ``summary.json``."""
    args = parse_args(argv)
    work = os.path.abspath(args.work)
    model = os.path.abspath(args.model or f'{work}/pair-train')
    eval_yaml = os.path.abspath(args.eval_yaml or f'{work}/eval.yaml')
    outdir = os.path.abspath(args.out or f'{work}/holdout')
    os.makedirs(outdir, exist_ok=True)
    py = sys.executable
    if args.one_process:
        from ..cli._common import report_at_exit
        report_at_exit('holdout_sweep')
    state = {}

    per_seed = {}
    for seed in range(args.seeds):
        odir = f'{work}/holdout_s{seed}'
        done = (os.path.isdir(odir)
                and any(f.endswith('.json') for f in os.listdir(odir)))
        cmd = [py, '-m', 'xpoint_tpu_torch.cli.benchmark', '-y', eval_yaml,
               '-m', model, '-e', '-s', str(seed), '-o', odir,
               '--device', args.device]
        if done:
            # a seed whose output JSON exists is not evaluated again
            print(f'+ seed {seed}: reusing {odir}', flush=True)
        elif args.one_process:
            print(f'+ seed {seed}: in-process eval', flush=True)
            run_seed_inprocess(state, seed, eval_yaml, model, odir,
                               args.device)
        else:
            print('+', ' '.join(cmd), flush=True)
            subprocess.run(cmd, check=True, cwd=REPO)
        outs = sorted((os.path.join(r, f) for r, _, fs in os.walk(odir)
                       for f in fs if f.endswith('.json')),
                      key=os.path.getmtime)
        with open(outs[-1]) as f:
            res = json.load(f)
        per_seed[seed] = seed_metrics(res)
        dst = os.path.join(outdir, f'mini_corpus_metrics_s{seed}.json')
        with open(outs[-1]) as fi, open(dst, 'w') as fo:
            fo.write(fi.read())
        print(f"seed {seed}: {per_seed[seed]}", flush=True)

    summary = summarize(per_seed)
    with open(os.path.join(outdir, 'summary.json'), 'w') as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != 'per_seed'}, indent=1))
    print(f"summary written to {os.path.join(outdir, 'summary.json')}")
    return summary


if __name__ == '__main__':
    main()
