"""The full self-supervised cycle on the deterministic mini-corpus, end to
end (port of ``tools/full_cycle.py``):

    1. generate the mini corpus (``tools.make_mini_corpus``, seeds fixed),
    1b. cache the synthetic-shapes set (``write_synthetic_set``),
    2. synthetic-shapes pretrain of a detector        (``cli.train``),
    3. homographic-adaptation label export   (``cli.export_keypoints``),
    4. pair training with descriptors                 (``cli.train``),
    5. registration evaluation          (``cli.benchmark -e``, with the
       MAGSAC estimator and again with the device one),
    5a. with ``--classical``, the SIFT baseline over the same protocol
       (``cli.benchmark -m none -v none -e`` with the ClassicDetectors model
       section), written to ``<out>_classical.json``,

then the metrics (repeatability / NN-mAP / M-score / h-correctness sweeps
in the JSON of the JAX package's ``cli/benchmark.py -e``, with the device
estimator's curve under ``homography_device``) are written to ``--out``:

    python -m xpoint_tpu_torch.tools.full_cycle --work WORK_DIR

Each stage is a process of its own, ``python -m xpoint_tpu_torch.<stage>``
run from the repository root, as the JAX tool runs its CLIs, on
``--device`` (default ``cuda``). The five configs are the JAX tool's, key
for key, except that every file is ``.npz`` where the JAX tool's is
``.hdf5``: the card's machine has no h5py, and the port's datasets read
both (``data/group_file.py``). ``--out`` defaults to
``<work>/mini_corpus_metrics.json``, not the JAX side's committed
``metrics/mini_corpus_metrics.json``. ``--reuse-model`` looks for
``<work>/pair-train/latest.pt``.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


SYNTH_CFG = """
dataset:
    type: 'SyntheticShapes'
    primitives: 'all'
    on-the-fly: false
    hdf5-file: {work}/synthetic.npz
    processing:
        blur_size: 21
        additional_ir_blur: true
        additional_ir_blur_size: 51
    augmentation:
        photometric:
            enable: true
            primitives: ['random_brightness', 'random_contrast',
                         'additive_speckle_noise', 'additive_gaussian_noise']
            params:
                random_brightness: {max_abs_change: 0.15}
                random_contrast: {strength_range: [0.3, 1.8]}
                additive_gaussian_noise: {stddev_range: [0, 0.06]}
                additive_speckle_noise: {prob_range: [0, 0.0035]}
        homographic:
            enable: false
model:
    type: 'XPoint'
    multispectral: true
    descriptor_head: false
    final_batchnorm: true
    reflection_pad: true
    takes_pair: false
    homography_regression_head:
        check: false
loss:
    type: 'XPointLoss'
    detector_loss: true
    detector_loss_function: 'cross_entropy'
    detector_handle_multiple_keypoints: 'soft_assignment'
    detector_dustbin_loss_weight: 0.025
    descriptor_loss: false
training:
    batchsize: 16
    learningrate: 1e-3
    n_epochs: {synth_epochs}
    output_directory: {work}/synthetic-pretrain
    save_every_n_epoch: 0
    use_writer: false
"""

EXPORT_CFG = """
dataset:
    type: 'ImagePairDataset'
    filename: {work}/corpus/training.npz
    single_image: false
    augmentation:
        photometric:
            enable: false
        homographic:
            enable: false
prediction:
    allow_gpu: true
    num_worker: 0
    batchsize: 1
    detection_threshold: {export_det}
    nms: 4
    reprojection_threshold: 3
homographic_adaptation:
    num: {ha_num}
    aggregation: 'window'
    min_count: 2
    erosion_radius: 5
    mask_border: true
    homographies:
        translation: true
        rotation: true
        scaling: true
        perspective: true
        scaling_amplitude: 0.15
        perspective_amplitude_x: 0.15
        perspective_amplitude_y: 0.15
        patch_ratio: 0.9
        max_angle: 3.14159
        allow_artifacts: true
"""

PAIR_CFG = """
dataset:
    type: 'ImagePairDataset'
    filename: {work}/corpus/training.npz
    keypoints_filename: {work}/labels.npz
    single_image: false
    random_pairs: false
    height: 256
    width: 256
    augmentation:
        photometric:
            enable: false
        homographic:
            enable: true
            params:
                translation: true
                rotation: true
                scaling: true
                perspective: true
                scaling_amplitude: 0.2
                perspective_amplitude_x: 0.2
                perspective_amplitude_y: 0.2
                patch_ratio: 0.85
                max_angle: 1.57
                allow_artifacts: true
                translation_overflow: 0.05
            valid_border_margin: 0
            border_reflect: true
model:
    type: 'XPoint'
    multispectral: {multispectral}
    descriptor_head: true
    descriptor_size: 256
    intepolation_mode: bilinear
    normalize_descriptors: true
    final_batchnorm: true
    reflection_pad: true
    mixed_precision: true
    takes_pair: true
    # per-spectrum BN running stats: without this, eval-time BN uses one
    # shared running average for both modalities while the separate-forward
    # train step normalized each modality by its own batch stats — measured
    # cross-modal descriptor cosine collapse 0.95 -> 0.33 on the same
    # weights (models/heads.py SpectralBatchNorm)
    spectral_norm_stats: true
    homography_regression_head:
        check: false
loss:
    type: 'XPointLoss'
    detector_loss: true
    detector_loss_function: 'cross_entropy'
    detector_handle_multiple_keypoints: 'soft_assignment'
    detector_dustbin_loss_weight: 0.025
    descriptor_loss: true
    descriptor_loss_threshold: 4.0
    descriptor_loss_use_mask: true
    sparse_descriptor_loss: false
    positive_margin: 1.0
    negative_margin: 0.2
    lambda_d: 250
    lambda: 1.0
    hard_negative_weighting:
        check: {hard_neg_check}
        temperature: {hard_neg_tau}
        weight: {hard_neg_weight}
        keep_uniform: {hard_neg_keep_uniform}
training:
    batchsize: 8
    learningrate: {pair_lr}
    n_epochs: {pair_epochs}
    device_data: {device_data}
    scheduler:
        use_scheduler: {use_sched}
        type: 'StepLR'
        gamma: {sched_gamma}
        step_size: {sched_step}
    output_directory: {work}/pair-train
    save_every_n_epoch: {save_every}
    use_writer: false
"""

EVAL_CFG = """
dataset:
    type: 'ImagePairDataset'
    filename: {work}/corpus/test.npz
    keypoints_filename:
    single_image: false
    random_pairs: false
    height: 256
    width: 256
    augmentation:
        photometric:
            enable: false
        homographic:
            enable: true
            params:
                translation: true
                rotation: true
                scaling: true
                perspective: true
                scaling_amplitude: 0.1
                perspective_amplitude_x: 0.05
                perspective_amplitude_y: 0.05
                patch_ratio: 0.90
                max_angle: 1.57
                allow_artifacts: true
                translation_overflow: 0.05
            valid_border_margin: 4
            border_reflect: true
prediction:
    disable_hmhead: true
    allow_gpu: true
    num_worker: 0
    batchsize: 1
    # operating point re-tuned for the round-5 hard-negative-hinge recipe
    # (tools/op_sweep.py grid, docs/ROUND5_NOTES.md): det-threshold is a
    # cliff (h@3 0.72/NN-mAP 0.155 at det 0.003 -> 0.55/0.25 at 0.005,
    # nothing between), but a top-k cap on the NMS survivors trades
    # smoothly — topk 1024 keeps h@3 0.609 (vs SIFT 0.328) while lifting
    # NN-mAP@3 to 0.207 (2x the uncapped 0.162; SIFT 0.276). The
    # registration-max point (topk 0: h@3 0.766) stays documented in the
    # sweep table; the committed point takes the balanced one. subpixel
    # refinement stays off (measured neutral-to-negative on
    # h-correctness: it tightens already-good fits but flips borderline
    # registrations)
    detection_threshold: 0.001
    subpixel: false
    nms: 4
    topk: 1024
    reprojection_threshold: 3
    matching:
        method: bfmatcher
        method_kwargs:
            crossCheck: True
        knn_matches: False
"""


CLASSICAL_MODEL_CFG = """
model:
    type: 'ClassicDetectors'
    method: 'SIFT'
    takes_pair: false
"""


def write_synthetic_set(path, n):
    """Cache ``n`` synthetic-shapes samples (the dataset's default sizes:
    drawn at 960 x 1280, kept at 240 x 320) as groups ``s%05d`` holding
    ``image`` (uint8) and ``points`` (float32 (row, col)), drawn in
    sequence from one ``np.random.RandomState(0)`` and one
    ``random.Random(0)``: the samples of the JAX tool's inline
    pre-generation after ``random.seed(0); np.random.seed(0)``. Generating
    on the fly costs ~100 ms a sample on the host; the cached set leaves
    only the photometric augmentation to every epoch."""
    import random

    import numpy as np

    from ..data.group_file import write_npz_groups
    from ..data.synthetic_shapes import SyntheticShapes

    ds = SyntheticShapes({'primitives': 'all'})
    rng, py_rng = np.random.RandomState(0), random.Random(0)

    def groups():
        for i in range(n):
            img, kp, _ = ds.generate_synthetic_image(rng, py_rng)
            yield 's%05d' % i, {
                'image': (img * 255).astype('uint8'),
                'points': np.asarray(kp, 'float32')}
    write_npz_groups(path, groups())


def sh(cmd, **kw):
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO, **kw)


def classical_stage(benchmark_cmd, eval_yaml, outputs, out_path, dev):
    """Stage 5a: ``cli.benchmark -m none -v none -e`` on ``eval_yaml`` (the
    evaluation config with a ClassicDetectors model section) in a process
    of its own, then its newest JSON copied to ``<out>_classical.json``
    (``out_path`` with ``.json`` replaced). Returns that path."""
    sh(benchmark_cmd + ['-y', eval_yaml, '-m', 'none', '-v', 'none', '-e',
                        '-o', outputs] + dev)
    outs = _newest_json(outputs)
    assert outs, "the classical benchmark produced no JSON"
    cls_out = out_path.replace('.json', '_classical.json')
    os.makedirs(os.path.dirname(cls_out), exist_ok=True)
    with open(outs[-1]) as f_in, open(cls_out, 'w') as f_out:
        f_out.write(f_in.read())
    return cls_out


def _newest_json(root):
    return sorted((os.path.join(r, f) for r, _, fs in os.walk(root)
                   for f in fs if f.endswith('.json')), key=os.path.getmtime)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--work',
                    default=os.path.join(tempfile.gettempdir(), 'cycle'))
    ap.add_argument('--n-train', type=int, default=128)
    ap.add_argument('--n-test', type=int, default=64)
    ap.add_argument('--size', type=int, default=512)
    ap.add_argument('--gap', choices=('v1', 'v2'), default='v1',
                    help="corpus spectral gap (make_mini_corpus --gap): "
                         "v2 adds dead-leaves backgrounds + partial "
                         "contrast inversion")
    ap.add_argument('--synth-epochs', type=int, default=60)
    ap.add_argument('--synth-samples', type=int, default=1500)
    ap.add_argument('--pair-epochs', type=int, default=600)
    ap.add_argument('--pair-lr', default='3e-4')
    ap.add_argument('--pair-sched-gamma', type=float, default=None,
                    help='enable a StepLR decay on pair training: multiply '
                         'the lr by this factor every --pair-sched-step '
                         'epochs (reference train.py scheduler semantics)')
    ap.add_argument('--pair-sched-step', type=int, default=600)
    ap.add_argument('--save-every', type=int, default=0,
                    help='pair-train checkpoint cadence (e{N} snapshots; '
                         '0 = latest-only) — makes long runs resumable '
                         '(cli.train --resume)')
    ap.add_argument('--ha-num', type=int, default=50)
    ap.add_argument('--multispectral', action='store_true',
                    help='pair-train with TWO encoders routed by spectrum '
                         '(the reference production mode for real data, '
                         'XPoint.py:284-305) instead of one shared encoder')
    ap.add_argument('--hard-neg-weight', type=float, default=None,
                    help='enable softmax-weighted hard-negative emphasis in '
                         'the descriptor hinge at this weight (extension, '
                         'losses/xpoint_loss.py hard_negative_weighting)')
    ap.add_argument('--hard-neg-tau', type=float, default=0.1)
    ap.add_argument('--hard-neg-replace-uniform', action='store_true',
                    help='drop the reference uniform negative term when '
                         'hard-negative weighting is on')
    ap.add_argument('--export-det', type=float, default=0.015,
                    help='HA-export detection threshold; lower = denser '
                         'labels (the thermal side detects ~3x fewer '
                         'keypoints than optical at the 0.015 default)')
    ap.add_argument('--reuse-synth', default=None,
                    help='path to an existing synthetic-pretrain output dir '
                         '(skips corpus-INDEPENDENT steps 1b/2 — the '
                         'synthetic-shapes detector never sees the pair '
                         'corpus, so reuse is sound when iterating on the '
                         'corpus or pair-training recipe)')
    ap.add_argument('--reuse-labels', action='store_true',
                    help='skip corpus generation + HA export when '
                         '{work}/corpus and {work}/labels.npz already '
                         'exist — sound when iterating only on the '
                         'pair-training recipe (the labels depend on the '
                         'corpus + synth detector, which are unchanged)')
    ap.add_argument('--reuse-model', action='store_true',
                    help='skip pair training when {work}/pair-train already '
                         'holds latest.pt — regenerates the metrics (e.g. '
                         'after an eval operating-point change) without '
                         'the retrain')
    ap.add_argument('--reuse-corpus', action='store_true',
                    help='skip corpus generation when {work}/corpus already '
                         'holds both splits — HA export and pair training '
                         'still run fresh')
    ap.add_argument('--device-data', action='store_true',
                    help='pair training with the corpus resident on the '
                         'card and augmentation inside the train step '
                         '(data/device_dataset.py); different random '
                         'streams than the host path')
    ap.add_argument('--out', default=None,
                    help='metrics JSON (default '
                         '{work}/mini_corpus_metrics.json)')
    ap.add_argument('--classical', action='store_true',
                    help='also run the SIFT ClassicDetectors baseline '
                         '(stage 5a) and write <out>_classical.json')
    ap.add_argument('--require-sensitive', action='store_true',
                    help='fail unless h-correctness@3 (MAGSAC, reproj th 2 '
                         'sweep, evaluation.py:368-393) lands strictly '
                         'inside (0, 1) — i.e. the benchmark can move in '
                         'BOTH directions on a regression')
    ap.add_argument('--device', default='cuda',
                    help='torch device of every stage (default: cuda)')
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the cycle; returns the metrics dict written to ``--out``."""
    args = parse_args(argv)
    w = os.path.abspath(args.work)
    os.makedirs(w, exist_ok=True)
    out_path = os.path.abspath(args.out or f'{w}/mini_corpus_metrics.json')
    py = sys.executable
    dev = ['--device', args.device]

    def cfg(tpl, name, **fmt):
        # plain substitution (str.format would choke on YAML flow braces)
        body = tpl.replace('{work}', w)
        for k, v in fmt.items():
            body = body.replace('{%s}' % k, str(v))
        path = os.path.join(w, name)
        with open(path, 'w') as f:
            f.write(body)
        return path

    def tool(name):
        return [py, '-m', f'xpoint_tpu_torch.{name}']

    reuse_labels = (args.reuse_labels
                    and os.path.isdir(f'{w}/corpus')
                    and os.path.exists(f'{w}/labels.npz'))
    reuse_corpus = (args.reuse_corpus
                    and os.path.exists(f'{w}/corpus/training.npz')
                    and os.path.exists(f'{w}/corpus/test.npz'))
    # 1. corpus
    if reuse_labels:
        print(f"+ reusing corpus + labels in {w} "
              f"(regenerating test split at n={args.n_test})", flush=True)
        sh(tool('tools.make_mini_corpus') + [
            '--out', f'{w}/corpus', '--n-test', str(args.n_test),
            '--size', str(args.size), '--splits', 'test', '--gap', args.gap])
    elif reuse_corpus:
        print(f"+ reusing pre-generated corpus in {w}/corpus", flush=True)
    else:
        sh(tool('tools.make_mini_corpus') + [
            '--out', f'{w}/corpus', '--n-train', str(args.n_train),
            '--n-test', str(args.n_test), '--size', str(args.size),
            '--gap', args.gap])
    synth_dir = args.reuse_synth or f'{w}/synthetic-pretrain'
    # 1b. the synthetic-shapes set, cached once (write_synthetic_set)
    if not args.reuse_synth and not os.path.exists(f'{w}/synthetic.npz'):
        sh([py, '-c',
            "from xpoint_tpu_torch.cli._common import report_at_exit;"
            "from xpoint_tpu_torch.tools.full_cycle import "
            "write_synthetic_set;"
            "report_at_exit('synthetic_set');"
            f"write_synthetic_set({f'{w}/synthetic.npz'!r}, "
            f"{args.synth_samples})"])
    # 2. synthetic pretrain
    if args.reuse_synth:
        print(f"+ reusing synthetic pretrain from {synth_dir}", flush=True)
    else:
        sh(tool('cli.train') + [
            '-y', cfg(SYNTH_CFG, 'synth.yaml',
                      synth_epochs=args.synth_epochs)] + dev)
    # 3. HA label export
    if not reuse_labels:
        sh(tool('cli.export_keypoints') + [
            '-y', cfg(EXPORT_CFG, 'export.yaml', ha_num=args.ha_num,
                      export_det=args.export_det),
            '-o', f'{w}/labels.npz', '-m', synth_dir] + dev)
    # 4. pair training
    if args.reuse_model and os.path.exists(f'{w}/pair-train/latest.pt'):
        print(f"+ reusing trained pair model in {w}/pair-train", flush=True)
    else:
        sh(tool('cli.train') + [
            '-y', cfg(PAIR_CFG, 'pair.yaml', pair_epochs=args.pair_epochs,
                      pair_lr=args.pair_lr,
                      use_sched=str(args.pair_sched_gamma is not None).lower(),
                      sched_gamma=(args.pair_sched_gamma
                                   if args.pair_sched_gamma is not None
                                   else 1.0),
                      sched_step=args.pair_sched_step,
                      device_data=str(bool(args.device_data)).lower(),
                      multispectral=str(bool(args.multispectral)).lower(),
                      hard_neg_check=str(
                          args.hard_neg_weight is not None).lower(),
                      hard_neg_tau=args.hard_neg_tau,
                      hard_neg_weight=(args.hard_neg_weight
                                       if args.hard_neg_weight is not None
                                       else 0.0),
                      hard_neg_keep_uniform=str(
                          not args.hard_neg_replace_uniform).lower(),
                      save_every=args.save_every)] + dev)
    # 5. evaluation sweep (reference benchmark.py -e JSON schema)
    sh(tool('cli.benchmark') + [
        '-y', cfg(EVAL_CFG, 'eval.yaml'), '-m', f'{w}/pair-train', '-e',
        '-o', f'{w}/outputs'] + dev)
    # 5a. the classical baseline over the same protocol (test split, seed-0
    # warp draws, prediction operating point), its model built from the
    # config with `-v none`: anchors the learned model's numbers to SIFT's
    if args.classical:
        classical_out = classical_stage(
            tool('cli.benchmark'), cfg(EVAL_CFG + CLASSICAL_MODEL_CFG,
                                       'eval_classical.yaml'),
            f'{w}/outputs_classical', out_path, dev)
        print(f"classical baseline written to {classical_out}", flush=True)
    # 5b. second homography sweep with the on-device estimator
    # (prediction: h_estimator: device) — same seeded warp draws, so the
    # two curves are directly comparable; recorded under
    # 'homography_device' next to the MAGSAC curve
    sh(tool('cli.benchmark') + [
        '-y', cfg(EVAL_CFG.replace('prediction:\n',
                                   'prediction:\n    h_estimator: device\n'),
                  'eval_device.yaml'),
        '-m', f'{w}/pair-train', '-e', '-o', f'{w}/outputs_device'] + dev)

    # collect the newest results JSON
    outs = _newest_json(f'{w}/outputs')
    assert outs, "benchmark produced no JSON"
    with open(outs[-1]) as f:
        res = json.load(f)
    outs_dev = _newest_json(f'{w}/outputs_device')
    if outs_dev:
        with open(outs_dev[-1]) as f:
            res['homography_device'] = json.load(f).get('homography', {})
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, 'w') as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in list(res)[:12]}, indent=1)[:2000])
    print(f"metrics written to {args.out or out_path}", flush=True)

    hc3 = (res.get('homography', {}).get('2', {})
           .get('h_correctness', {}).get('epsilon_warp_th3'))
    print(f"h-correctness@3px (MAGSAC, reproj th 2): {hc3}", flush=True)
    hc3_dev = (res.get('homography_device', {}).get('2', {})
               .get('h_correctness', {}).get('epsilon_warp_th3'))
    print(f"h-correctness@3px (device RANSAC, reproj th 2): {hc3_dev}",
          flush=True)
    if args.require_sensitive:
        assert hc3 is not None and 0.0 < hc3 < 1.0, (
            f"registration benchmark is not sensitive: h-correctness@3 = "
            f"{hc3} (must be strictly inside (0, 1) so regressions can "
            f"move it)")
    return res


if __name__ == '__main__':
    main()
