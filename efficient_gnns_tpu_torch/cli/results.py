"""Render RESULTS.md from the JSON artifacts the port's training CLIs write
(counterpart of ``efficient_gnns_tpu/cli/results.py``, with the same
markdown apart from the package name in its title lines):

    python -m efficient_gnns_tpu_torch.cli.results --dir logs/results \
        --out RESULTS.md

Mean ± std over seeds from the stored result files. The seed count of a
workload's table is read from ``runs``, ``n_runs`` or ``num_runs`` (the SIGN
CLI's name); the JAX renderer reads the first two only and prints ``?`` for
a SIGN file.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def _ms(vals):
    import numpy as np

    a = np.asarray(vals, dtype=float)
    if a.size == 0:
        return "—"
    return f"{a.mean() * 100:.2f} ± {a.std() * 100:.2f}"


def _load(path):
    with open(path) as f:
        return json.load(f)


def render(results_dir: str) -> str:
    import numpy as np

    lines = []
    add = lines.append
    add("# RESULTS — GPU runs (efficient_gnns_tpu_torch)")
    add("")
    add("Generated by `python -m efficient_gnns_tpu_torch.cli.results` from the")
    add(f"JSON artifacts under `{results_dir}/` — every number below was")
    add("produced by the training CLIs on the hardware named in each table;")
    add("commands are in `experiments/arxiv_hard.sh`, "
        "`experiments/all_workloads.sh`, and the round-5 scripts "
        "`experiments/r5_{teacher,students,students_rest,workloads,"
        "workloads2,ppi_rest,final,realscale}.sh`.")
    add("All accuracies are % (mean ± std over seeds).")
    add("")
    add("The node-classification task is the *hardened synthetic* "
        "ogbn-arxiv-shaped dataset (169,343 nodes / 1.17M directed edges, "
        "128-d features, 40 classes, signal 0.3 + 15% label noise — "
        "`data/synthetic.py`), because this environment has no network "
        "egress for OGB downloads. Real-OGB parity runs use the same CLIs "
        "with `--dataset ogbn-arxiv` once a data cache is mounted.")
    add("")

    # ---- GAT teacher ------------------------------------------------------
    teacher_files = sorted(glob.glob(
        os.path.join(results_dir, "gat_teacher_*.json")))
    main_teachers = [p for p in teacher_files
                     if "sanity" not in p and "probe" not in p]
    if main_teachers:
        add("## GAT teacher (ogbn-arxiv shape)")
        add("")
        add("Reference: `arxiv_dgl/gat.py` (3L x 250 x 3 heads, "
            "`--use-labels --n-label-iters 1 --no-attn-dst --use-norm "
            "--edge-drop 0.3 --input-drop 0.25`), 1,441,580 params — "
            "identical architecture/flags here, trained with the hub-dense "
            "attention fast path (ops/hub_attention.py, bf16 messages).")
        add("")
        add("| config | seeds | best val | final test |")
        add("|---|---|---|---|")
        for p in main_teachers:
            d = _load(p)
            name = os.path.basename(p)[len("gat_teacher_"):-len(".json")]
            add(f"| {name} ({d['args']['n_epochs']} epochs) "
                f"| {len(d['val_accs'])} | {_ms(d['val_accs'])} "
                f"| {_ms(d['test_accs'])} |")
        add("")

    # ---- arxiv students ---------------------------------------------------
    student_files = sorted(glob.glob(os.path.join(results_dir, "hard-*.json")))
    if student_files:
        add("## Students (ogbn-arxiv shape, offline teacher dumps)")
        add("")
        add("Reference: `arxiv_pyg/gnn.py` / `gnn_kd_and_aux.py` students "
            "(GCN 2L x 256, SAGE 2L x 256) consuming the per-seed teacher "
            "dumps. `kd` = logit KD (alpha 0.9, T 4); `nce` = G-CRD "
            "(beta 0.05, tau 0.075, proj 256); `kd+nce` composes both.")
        add("")
        add("| student | mode | seeds | best val | final test | s/epoch |")
        add("|---|---|---|---|---|---|")
        for p in student_files:
            d = _load(p)
            a = d["args"]
            mode = a["training"] + ("+kd" if a.get("kd_and_aux") else "")
            if a.get("kd_and_aux"):
                mode = "kd+" + a["training"]
            vals = [r["highest_valid"] for r in d.get("runs", [])]
            tests = [r["final_test"] for r in d.get("runs", [])]
            sv, st = _ms(vals), _ms(tests)
            secs = [r["seconds"] / a["epochs"] for r in d.get("runs", [])
                    if "seconds" in r]
            s_epoch = f"{np.mean(secs):.3f}" if secs else "—"
            add(f"| {a['gnn']} {a['num_layers']}L x {a['hidden_channels']} "
                f"| {mode} | {a['runs']} | {sv} | {st} | {s_epoch} |")
        add("")

    # ---- other workloads --------------------------------------------------
    def section(pattern, title, note):
        files = sorted(glob.glob(os.path.join(results_dir, pattern)))
        if not files:
            return
        add(f"## {title}")
        add("")
        add(note)
        add("")
        add("| run | seeds | best val | final test | timing |")
        add("|---|---|---|---|---|")
        for p in files:
            d = _load(p)
            stats = d.get("statistics", {})
            a = d.get("args", {})
            n_seeds = a.get("runs", a.get("n_runs", a.get("num_runs")))
            seeds = (f"**{n_seeds} (single seed)**" if n_seeds == 1
                     else str(n_seeds) if n_seeds else "?")
            sv = (f"{stats.get('highest_valid_mean', float('nan')) * 100:.2f}"
                  f" ± {stats.get('highest_valid_std', 0.0) * 100:.2f}")
            st = (f"{stats.get('final_test_mean', float('nan')) * 100:.2f}"
                  f" ± {stats.get('final_test_std', 0.0) * 100:.2f}")
            extra = []
            raw_es = d.get("epoch_seconds", [])
            if isinstance(raw_es, dict):  # per-run lists (cli/mag r5 format)
                raw_es = [v for run in sorted(raw_es) for v in raw_es[run]]
            es = [v for v in raw_es if isinstance(v, (int, float))]
            if es:
                extra.append(f"epoch {np.median(es):.2f}s")
            dev = [v["device_step_ms"] for v in raw_es
                   if isinstance(v, dict) and "device_step_ms" in v]
            if dev:
                extra.append(f"device step {np.median(dev):.1f} ms")
            name = os.path.basename(p).rsplit(".", 1)[0]
            add(f"| {name} | {seeds} | {sv} | {st} | {', '.join(extra) or '—'} |")
        add("")

    bench = os.path.join(results_dir, "notes.md")
    if os.path.exists(bench):
        add(open(bench).read())

    section("mag-*.json", "ogbn-mag R-GCN (GraphSAINT, online teacher)",
            "Reference: `mag_pyg/gnn.py`. Typed-square single-pass R-GCN "
            "SpMM (models/layers.py) unless the file says fallback.")
    section("ppi-*.json", "PPI (inductive, micro-F1)",
            "Reference: `ppi_pyg/gnn.py` / `train_teacher.py`.")
    section("mol-*.json", "ogbg-molhiv (graph classification, ROC-AUC)",
            "Reference: `mol_pyg` results table (code unreleased upstream).")
    section("sign-*.json", "SIGN (hop-precompute + minibatch MLP)",
            "Reference: `arxiv_dgl/sign.py`.")

    bench = os.path.join(results_dir, "bench_notes.md")
    if os.path.exists(bench):
        add(open(bench).read())
    return "\n".join(lines) + "\n"


def main(argv=None):
    p = argparse.ArgumentParser("results aggregator")
    p.add_argument("--dir", type=str, default="logs/results")
    p.add_argument("--out", type=str, default="RESULTS.md")
    args = p.parse_args(argv)
    md = render(args.dir)
    with open(args.out, "w") as f:
        f.write(md)
    print(f"wrote {args.out} ({len(md.splitlines())} lines)")


if __name__ == "__main__":
    main()
