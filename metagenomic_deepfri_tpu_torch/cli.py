"""Command line of the port.

    python -m metagenomic_deepfri_tpu_torch.cli predict-function \\
        -i queries.faa -d DB -w WEIGHTS -o OUT --device cuda

The verbs of the JAX package's command line (``metagenomic_deepfri_tpu/
cli.py``) with its flags, names and defaults: ``search-databases``,
``predict-function``, ``make-cmaps``, ``generate-config``, ``get-models``,
``get-binaries``, ``finetune``, ``merge-results``, ``verify-weights``,
``serve`` and ``benchmark``, plus the group's ``--debug`` and
``--version``. The verbs that run a model (``predict-function``,
``finetune``, ``verify-weights``, ``serve``, ``benchmark``) take
``--device``, ``cuda`` unless the caller names another (``cpu`` runs on
the host). Nothing falls back: without the CUDA device asked for, the verb
exits 1 with an error naming it.
``predict-function``, ``serve`` and ``finetune`` also take several,
comma-separated (``--device cuda:0,cuda:1``): the engine then runs
data-parallel over them, and fine-tuning one rank a device.

The command line uses ``argparse`` only. A usage error prints the verb's
full help and exits 2 (the JAX package's ``patch_usage_error``); a failed
download exits 1 with its message.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import urllib.error
from pathlib import Path

import numpy as np

from metagenomic_deepfri_tpu_torch import __version__
from metagenomic_deepfri_tpu_torch.utils import DownloadError

logger = logging.getLogger(__name__)

ALL_MODES = ["bp", "cc", "ec", "mf"]


class _Parser(argparse.ArgumentParser):
    """Prints the full help before a usage error (reference
    ``cli.py:67-92``)."""

    def error(self, message):
        self.print_help(sys.stderr)
        self.exit(2, f"\n{self.prog}: error: {message}\n")


def _path_type(exists: bool = False, file_okay: bool = True,
               dir_okay: bool = True):
    """An argparse type like ``click.Path(exists=..., file_okay=...,
    dir_okay=...)`` giving a :class:`Path`."""
    def convert(value: str) -> Path:
        path = Path(value)
        if exists and not path.exists():
            raise argparse.ArgumentTypeError(f"path {value!r} does not exist")
        if path.exists():
            if not file_okay and path.is_file():
                raise argparse.ArgumentTypeError(f"{value!r} is a file")
            if not dir_okay and path.is_dir():
                raise argparse.ArgumentTypeError(f"{value!r} is a directory")
        return path
    return convert


def _sensitivity(value: str) -> float:
    """``click.FloatRange(1, 7.5)``."""
    s = float(value)
    if not 1 <= s <= 7.5:
        raise argparse.ArgumentTypeError(
            f"{value} is not in the range 1<=x<=7.5")
    return s


def setup_logging(debug: bool = False) -> None:
    """Root logger configuration (reference cli.py:46-56)."""
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.INFO,
        format="%(asctime)s %(levelname)-7s %(name)s :: %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
        handlers=[logging.StreamHandler(sys.stdout)],
        force=True,
    )


def log_command_params(args: argparse.Namespace) -> None:
    """Dump invocation parameters to the log (reference cli.py:59-64)."""
    params = {k: v for k, v in vars(args).items()
              if k not in ("verb", "func", "debug")}
    logger.info("Command parameters:")
    width = max(len(k) for k in params) if params else 0
    for key, value in params.items():
        logger.info(f"{key:<{width + 2}} : {value}")


def _add_search_options(p: argparse.ArgumentParser) -> None:
    """Shared search flags (reference cli.py:96-221; defaults from
    https://doi.org/10.1038/s41586-023-06510-w)."""
    p.add_argument("-i", "--input", required=True,
                   type=_path_type(exists=True, dir_okay=False),
                   help="Path to input protein sequences (FASTA file, may be "
                        "gzipped).")
    p.add_argument("-o", "--output", required=True, type=Path,
                   help="Path to output file or directory.")
    p.add_argument("-d", "--db-path", action="append", default=[],
                   type=_path_type(exists=True),
                   help="Path to a structures database (FoldComp, FASTA, or "
                        "a directory of .pdb/.cif[.gz] files); repeatable.")
    p.add_argument("-s", "--mmseqs-sensitivity", default=5.7,
                   type=_sensitivity,
                   help="Sensitivity of the MMseqs2 search (default: 5.7).")
    p.add_argument("--min-length", default=None, type=int,
                   help="Minimum length of the protein sequence.")
    p.add_argument("--max-length", default=None, type=int,
                   help="Maximum length of the protein sequence.")
    p.add_argument("--mmseqs-min-bitscore", default=0, type=float,
                   help="Minimum bitscore for search hits (default: 0).")
    p.add_argument("--mmseqs-max-evalue", default=0.001, type=float,
                   help="Maximum e-value for search hits (default: 0.001).")
    p.add_argument("--mmseqs-min-identity", default=0.5, type=float,
                   help="Minimum identity for search hits (default: 0.5).")
    p.add_argument("--mmseqs-min-coverage", default=0.9, type=float,
                   help="Minimum coverage for search hits (query and target; "
                        "default: 0.9).")
    p.add_argument("--top-k", default=5, type=int,
                   help="Number of top search hits to save (default: 5).")
    p.add_argument("--overwrite", action="store_true",
                   help="Overwrite existing files.")
    p.add_argument("-t", "--threads", default=1, type=int,
                   help="Number of threads to use (default: 1).")
    p.add_argument("--skip-pdb", action="store_true",
                   help="Skip PDB100 database search.")
    p.add_argument("--tmpdir", default=None,
                   type=_path_type(file_okay=False),
                   help="Path to a temporary directory. Required for very "
                        "large searches.")
    p.add_argument("--shard", default=None, type=str,
                   help="'I/N': process only this host's deterministic slice "
                        "of the input catalogue (multi-host runs; merge the "
                        "per-host outputs with `merge-results`).")


def _search_kwargs(args) -> dict:
    return dict(mmseqs_sensitivity=args.mmseqs_sensitivity,
                min_bits=args.mmseqs_min_bitscore,
                max_eval=args.mmseqs_max_evalue,
                min_ident=args.mmseqs_min_identity,
                min_coverage=args.mmseqs_min_coverage,
                top_k=args.top_k, skip_pdb=args.skip_pdb,
                overwrite=args.overwrite, tmpdir=args.tmpdir,
                threads=args.threads)


def _query_file(args):
    from metagenomic_deepfri_tpu_torch.pipeline import load_query_file

    return load_query_file(query_file=args.input, min_length=args.min_length,
                           max_length=args.max_length, shard=args.shard)


def cmd_get_models(args) -> int:
    """Download model weights (ONNX + vocabularies) for DeepFRI."""
    from metagenomic_deepfri_tpu_torch.utils import (download_model_weights,
                                                     generate_config_json)

    logger.info("Downloading DeepFRI models.")
    output_path = Path(args.output)
    output_path.mkdir(parents=True, exist_ok=True)
    download_model_weights(output_path, args.version)
    generate_config_json(output_path, args.version)
    logger.info("DeepFRI models v%s downloaded to %s.", args.version,
                output_path)
    return 0


def cmd_get_binaries(args) -> int:
    """Download the external mmseqs/foldcomp engines for this CPU."""
    from metagenomic_deepfri_tpu_torch.search.binaries import fetch_binaries

    wanted = [t.strip() for t in args.tools.split(",") if t.strip()]
    for tool, path in fetch_binaries(args.output, wanted).items():
        print(f"{tool}: {path}")
    return 0


def cmd_generate_config(args) -> int:
    """Generate model_config.json for manually downloaded weights."""
    from metagenomic_deepfri_tpu_torch.utils import generate_config_json

    logger.info("Generating config file.")
    generate_config_json(Path(args.weights_path), args.version)
    logger.info("Config file generated in %s.", args.weights_path)
    return 0


def cmd_search_databases(args) -> int:
    """Hierarchically search structure databases for similar proteins."""
    from metagenomic_deepfri_tpu_torch.pipeline import \
        hierarchical_database_search

    log_command_params(args)
    hierarchical_database_search(query_file=_query_file(args),
                                 databases=args.db_path,
                                 output_path=args.output,
                                 **_search_kwargs(args))
    return 0


def cmd_predict_function(args) -> int:
    """Predict protein function from sequence (full pipeline), under
    :func:`..profiling.torch_trace` (a trace when ``MDEEPFRI_TPU_TRACE_DIR``
    is set)."""
    from metagenomic_deepfri_tpu_torch.profiling import torch_trace

    with torch_trace():
        return _predict_function(args)


def _predict_function(args) -> int:
    from metagenomic_deepfri_tpu_torch.pipeline import (
        hierarchical_database_search, predict_protein_function)

    logger.info("Starting metagenomic-deepfri-tpu (PyTorch port).")
    output_path = Path(args.output)
    output_path.mkdir(parents=True, exist_ok=True)
    log_command_params(args)

    deepfri_dbs = hierarchical_database_search(
        query_file=_query_file(args),
        output_path=output_path / "database_search",
        databases=args.db_path, **_search_kwargs(args))

    # refresh the query file: the search mutates it (reference cli.py:473-479)
    predict_protein_function(
        query_file=_query_file(args),
        databases=tuple(deepfri_dbs),
        weights=args.weights,
        output_path=output_path,
        deepfri_processing_modes=list(args.processing_modes or ALL_MODES),
        angstrom_contact_threshold=args.angstrom_contact_thresh,
        generate_contacts=args.generate_contacts,
        alignment_gap_open=args.alignment_gap_open,
        alignment_gap_continuation=args.alignment_gap_extend,
        remove_intermediate=args.remove_intermediate,
        threads=args.threads,
        save_structures=args.save_structures,
        save_cmaps=args.save_cmaps,
        skip_matrix=args.skip_matrix,
        scoring_matrix=args.scoring_matrix,
        propagate_go_terms=args.propagate_go_terms,
        obo_path=args.obo_path,
        device=args.device)
    return 0


def cmd_make_cmaps(args) -> int:
    """Compute CA contact maps for all PDB/mmCIF files in a directory (on
    the host, with numpy, as the JAX verb does)."""
    from metagenomic_deepfri_tpu_torch.data.structures import (
        get_residues_coordinates, load_structure)
    from metagenomic_deepfri_tpu_torch.ops.contact import \
        calculate_contact_map

    os.makedirs(args.output_dir, exist_ok=True)
    for fname in os.listdir(args.input_dir):
        if not fname.endswith((".pdb", ".cif")):
            continue
        filetype = "pdb" if fname.endswith(".pdb") else "mmcif"
        with open(os.path.join(args.input_dir, fname),
                  encoding="utf-8") as f:
            structure_str = f.read()
        _, coords = get_residues_coordinates(
            load_structure(structure_str, filetype), chain="A")
        cmap = calculate_contact_map(coords, args.threshold)
        # the JAX verb strips whichever structure extension the input has
        np.save(os.path.join(args.output_dir, fname[:-4] + "_cmap.npy"),
                cmap)
    return 0


def cmd_finetune(args) -> int:
    """Fine-tune a GCN on labelled structures."""
    from metagenomic_deepfri_tpu_torch.training import finetune

    path = finetune(args.weights, args.mode, args.structures, args.labels,
                    args.output, device=args.device, epochs=args.epochs,
                    learning_rate=args.learning_rate,
                    batch_size=args.batch_size,
                    contact_threshold=args.angstrom_contact_thresh,
                    model_parallel=args.model_parallel, seed=args.seed)
    print(f"Fine-tuned checkpoint written to {path}")
    return 0


def cmd_merge_results(args) -> int:
    """Merge per-host `--shard I/N` pipeline outputs into one directory."""
    from metagenomic_deepfri_tpu_torch.parallel.multihost import \
        merge_shard_results

    for path in merge_shard_results(args.shard_dirs, args.output):
        print(str(path))
    return 0


def cmd_verify_weights(args) -> int:
    """Check port-vs-ONNX numerical parity for every model in a weights
    folder."""
    from metagenomic_deepfri_tpu_torch.parity import verify_weights

    results = verify_weights(args.weights, device=args.device,
                             n_proteins=args.n_proteins,
                             tolerance=args.tolerance,
                             logit_tolerance=args.logit_tolerance,
                             seed=args.seed, trace=args.trace)
    for r in results:
        print(f"{r.net}/{r.mode}: scores max|diff|={r.max_abs_diff:.2e} "
              f"logits max|diff|={r.max_logit_diff:.2e} "
              f"({'OK' if r.ok else 'FAIL'})")
    failed = [r for r in results if not r.ok]
    if failed:
        print(f"Error: {len(failed)}/{len(results)} models exceed tolerance "
              f"{args.tolerance}", file=sys.stderr)
        return 1
    print(f"All {len(results)} models within {args.tolerance}.")
    return 0


def cmd_serve(args) -> int:
    """Run a resident annotation server on a Unix socket (JSONL protocol).

    Models stay on the device and databases stay indexed between requests:
    the serving counterpart of ``predict-function``. One JSON object a
    line, ``{"proteins": {id: sequence, ...}}`` in, ``{"results": ...,
    "skipped": ...}`` out. With ``MDEEPFRI_TPU_TRACE_DIR`` set, the whole
    session is traced (:func:`..profiling.torch_trace`; the trace is
    written when the server stops).
    """
    from metagenomic_deepfri_tpu_torch.profiling import torch_trace
    from metagenomic_deepfri_tpu_torch.serving import AnnotationServer

    server = AnnotationServer(
        args.weights,
        databases=list(args.db_path),
        processing_modes=args.processing_modes,
        max_eval=args.mmseqs_max_evalue,
        min_ident=args.mmseqs_min_identity,
        min_coverage=args.mmseqs_min_coverage,
        top_k=args.top_k,
        threads=args.threads,
        obo_path=args.obo,
        device=args.device)
    with torch_trace():
        server.serve_unix(args.socket)
    return 0


def cmd_benchmark(args) -> int:
    """Measure GCN inference throughput (proteins/sec) on this device."""
    from metagenomic_deepfri_tpu_torch.bench_utils import run_gcn_benchmark

    print(run_gcn_benchmark(bucket=args.bucket, batches=args.batches,
                            n_labels=args.n_labels, device=args.device),
          flush=True)
    return 0


def _device_option(p: argparse.ArgumentParser, several: bool = False) -> None:
    p.add_argument("--device", default="cuda",
                   help="Where the models run: cuda, cuda:1, cpu"
                   + ("; or several, comma-separated (cuda:0,cuda:1), to "
                      "run data-parallel over them" if several else "")
                   + " (default: %(default)s).")


def _missing_device(spec: str) -> str | None:
    """Why ``spec`` (a ``--device`` value) names no usable device, or
    None."""
    import torch

    from metagenomic_deepfri_tpu_torch.parallel.launch import device_list

    try:
        devices = device_list(spec)
    except (ValueError, RuntimeError) as err:
        return str(err)
    if devices[0].type != "cuda":
        return None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    missing = [str(d) for d in devices if (d.index or 0) >= n]
    if missing:
        return (f"{', '.join(missing)} not found ({n} CUDA devices "
                f"visible); pass --device cpu to run on the CPU")
    return None


def _parser() -> argparse.ArgumentParser:
    from metagenomic_deepfri_tpu_torch.parity import DEFAULT_TOLERANCE

    parser = _Parser(
        prog="python -m metagenomic_deepfri_tpu_torch.cli",
        description="metagenomic-deepfri-tpu, PyTorch port — protein "
                    "function annotation.")
    parser.add_argument("--debug", action=argparse.BooleanOptionalAction,
                        default=False)
    parser.add_argument("--version", action="version", version=__version__)
    verbs = parser.add_subparsers(dest="verb", required=True)

    def verb(name, func, help_text):
        p = verbs.add_parser(name, help=help_text, description=help_text)
        p.set_defaults(func=func)
        return p

    p = verb("get-models", cmd_get_models,
             "Download model weights (ONNX + vocabularies) for DeepFRI.")
    p.add_argument("-o", "--output", required=True,
                   type=_path_type(file_okay=False),
                   help="Path to folder where the model weights will be "
                        "downloaded.")
    p.add_argument("-v", "--version", required=True, choices=["1.0", "1.1"],
                   help="Version of the model.")

    p = verb("get-binaries", cmd_get_binaries,
             "Download the external mmseqs/foldcomp engines for this CPU.")
    p.add_argument("-o", "--output", default=None,
                   type=_path_type(file_okay=False),
                   help="Install directory (default: "
                        "~/.local/share/mdeepfri/bin, override with "
                        "MDEEPFRI_TOOLS_DIR).")
    p.add_argument("--tools", default="mmseqs,foldcomp",
                   help="Comma-separated subset of: mmseqs, foldcomp "
                        "(default: %(default)s).")

    p = verb("generate-config", cmd_generate_config,
             "Generate model_config.json for manually downloaded weights.")
    p.add_argument("-w", "--weights_path", required=True,
                   type=_path_type(exists=True, file_okay=False),
                   help="Path to a folder containing model weights.")
    p.add_argument("-v", "--version", required=True, choices=["1.0", "1.1"],
                   help="Version of the model.")

    p = verb("search-databases", cmd_search_databases,
             "Hierarchically search structure databases for similar "
             "proteins.")
    _add_search_options(p)

    p = verb("predict-function", cmd_predict_function,
             "Predict protein function from sequence (full pipeline).")
    _add_search_options(p)
    p.add_argument("-w", "--weights", required=True,
                   type=_path_type(exists=True, file_okay=False),
                   help="Path to a folder containing model weights.")
    _device_option(p, several=True)
    p.add_argument("-p", "--processing-modes", action="append",
                   choices=ALL_MODES, default=None,
                   help="Processing modes; repeatable. Default is all "
                        "(biological process, cellular component, enzyme "
                        "commission, molecular function).")
    p.add_argument("-a", "--angstrom-contact-thresh", default=6, type=float,
                   help="Angstrom contact threshold. Default is 6.")
    p.add_argument("--generate-contacts", default=2, type=int,
                   help="Gap fill threshold during contact map alignment.")
    p.add_argument("--alignment-gap-open", default=10, type=int,
                   help="Gap open penalty for alignment.")
    p.add_argument("--alignment-gap-extend", default=1, type=int,
                   help="Gap extend penalty for alignment.")
    p.add_argument("--remove-intermediate", action="store_true",
                   help="Remove intermediate files.")
    p.add_argument("--save-structures", action="store_true",
                   help="Save structures of the top hits.")
    p.add_argument("--save-cmaps", action="store_true",
                   help="Save contact maps of the top hits.")
    p.add_argument("--skip-matrix", action="store_true",
                   help="Skip writing prediction matrix files (saves disk "
                        "space).")
    p.add_argument("--scoring-matrix", default="auto",
                   help="Scoring matrix for sequence alignment (name or NCBI "
                        "matrix file; default: %(default)s).")
    p.add_argument("--propagate-go-terms", action="store_true",
                   help="Propagate GO terms up the ontology DAG (true-path "
                        "rule).")
    p.add_argument("--obo-path", default=None,
                   type=_path_type(dir_okay=False),
                   help="Path to a GO OBO file (go-basic.obo); downloaded "
                        "automatically when needed if not provided.")

    p = verb("make-cmaps", cmd_make_cmaps,
             "Compute CA contact maps for all PDB/mmCIF files in a "
             "directory.")
    p.add_argument("-i", "--input_dir", required=True,
                   type=_path_type(exists=True),
                   help="Directory containing PDB or mmCIF files.")
    p.add_argument("-o", "--output_dir", required=True,
                   help="Directory to save computed contact maps.")
    p.add_argument("-t", "--threshold", default=6.0, type=float,
                   help="Distance threshold in Å for contact map "
                        "(default: %(default)s).")

    p = verb("finetune", cmd_finetune,
             "Fine-tune a GCN on labelled structures.")
    p.add_argument("-w", "--weights", required=True,
                   type=_path_type(exists=True),
                   help="Base model weights folder (model_config.json "
                        "layout).")
    _device_option(p, several=True)
    p.add_argument("-m", "--mode", required=True,
                   choices=["bp", "cc", "mf", "ec"],
                   help="Ontology mode whose GCN to fine-tune.")
    p.add_argument("-i", "--structures", required=True,
                   type=_path_type(exists=True, file_okay=False),
                   help="Directory of labelled .pdb/.cif structure files.")
    p.add_argument("-l", "--labels", required=True,
                   type=_path_type(exists=True, dir_okay=False),
                   help="TSV: protein<TAB>GO:...;GO:... per line.")
    p.add_argument("-o", "--output", required=True, type=Path,
                   help="Output directory for the fine-tuned "
                        "checkpoint/ONNX.")
    p.add_argument("--epochs", default=5, type=int)
    p.add_argument("--learning-rate", default=1e-4, type=float)
    p.add_argument("--batch-size", default=8, type=int)
    p.add_argument("--model-parallel", default=1, type=int,
                   help="Tensor-parallel size: devices along the model "
                        "axis; must divide the number of --device entries "
                        "(default: %(default)s).")
    p.add_argument("--angstrom-contact-thresh", default=6.0, type=float)
    p.add_argument("--seed", default=0, type=int)

    p = verb("merge-results", cmd_merge_results,
             "Merge per-host `--shard I/N` pipeline outputs into one "
             "directory.")
    p.add_argument("shard_dirs", nargs="+",
                   type=_path_type(exists=True, file_okay=False))
    p.add_argument("-o", "--output", required=True, type=Path,
                   help="Directory for the merged catalogue-level results.")

    p = verb("verify-weights", cmd_verify_weights,
             "Check port-vs-ONNX numerical parity for every model in a "
             "weights folder.")
    p.add_argument("-w", "--weights", required=True,
                   help="Path to the folder containing model weights.")
    _device_option(p)
    p.add_argument("--n-proteins", type=int, default=10,
                   help="Random proteins per model (default: 10).")
    p.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                   help="Max allowed abs score difference port vs ONNX "
                        "(default: %(default)s).")
    p.add_argument("--logit-tolerance", type=float, default=None,
                   help="Max allowed scaled pre-softmax logit difference "
                        "(defaults to --tolerance).")
    p.add_argument("--trace", action="store_true",
                   help="On failure, log a per-stage divergence report "
                        "(embed/gc*/pooled/fc*/logits).")
    p.add_argument("--seed", type=int, default=0)

    p = verb("serve", cmd_serve,
             "Run a resident annotation server on a Unix socket (JSONL "
             "protocol).")
    p.add_argument("-w", "--weights", required=True,
                   type=_path_type(exists=True),
                   help="Path to the folder containing model weights.")
    _device_option(p, several=True)
    p.add_argument("-d", "--db-path", action="append", default=[],
                   type=_path_type(exists=True),
                   help="Structure database(s): FoldComp, FASTA, or a "
                        "directory of .pdb/.cif files; repeatable. Omit for "
                        "sequence-only (CNN) serving.")
    p.add_argument("--socket", required=True, type=Path,
                   help="Unix socket path to listen on.")
    p.add_argument("-p", "--processing-modes", action="append",
                   choices=["bp", "cc", "mf", "ec"], default=None,
                   help="Modes to serve; repeatable (default: all in "
                        "model_config.json).")
    p.add_argument("-t", "--threads", default=1, type=int,
                   help="Number of threads to use (default: %(default)s).")
    p.add_argument("--top-k", default=5, type=int,
                   help="Number of top search hits to keep (default: "
                        "%(default)s).")
    p.add_argument("--mmseqs-max-evalue", default=1e-5, type=float,
                   help="Maximum e-value for search hits (default: "
                        "%(default)s).")
    p.add_argument("--mmseqs-min-identity", default=0.5, type=float,
                   help="Minimum identity for search hits (default: "
                        "%(default)s).")
    p.add_argument("--mmseqs-min-coverage", default=0.9, type=float,
                   help="Minimum coverage for search hits (default: "
                        "%(default)s).")
    p.add_argument("--obo", default=None,
                   type=_path_type(exists=True, dir_okay=False),
                   help="go-basic.obo file: responses gain per-protein "
                        "propagated_scores (true-path GO propagation, the "
                        "serving analogue of results_propagated.tsv).")

    p = verb("benchmark", cmd_benchmark,
             "Measure GCN inference throughput (proteins/sec) on this "
             "device.")
    _device_option(p)
    p.add_argument("--bucket", default=512, type=int,
                   help="Length bucket to benchmark (default: %(default)s).")
    p.add_argument("--batches", default=8, type=int,
                   help="Number of timed batches (default: %(default)s).")
    p.add_argument("--n-labels", default=512, type=int,
                   help="Head width (default: %(default)s).")
    return parser


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    # the package's own loggers (the JAX verb sets every logger; torch's
    # would then log its internals)
    for name in list(logging.root.manager.loggerDict):
        if name.split(".")[0] == __package__:
            logging.getLogger(name).setLevel(
                logging.DEBUG if args.debug else logging.INFO)
    setup_logging(args.debug)
    if getattr(args, "device", None) is not None:
        why = _missing_device(args.device)
        if why:
            print(f"Error: --device {args.device}: {why}", file=sys.stderr)
            return 1
    try:
        return args.func(args)
    except (DownloadError, urllib.error.URLError) as err:
        # offline or a bad URL: a message, not a traceback
        print(f"Error: {err}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
