"""Frozen dataclass configs and the five named presets.

A copy of dssm_tpu/config/configs.py: the same fields, defaults, presets and
validation, so a preset name and a set of dotted overrides mean the same run
in both packages (tests/test_torch_data.py holds the two equal).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


class _Replaceable:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TowerConfig(_Replaceable):
    """Architecture of one (or both, if shared) semantic towers.

    V -> embed_width -> hidden_dims -> semantic_dim, tanh (or relu) at every
    layer, query and doc towers optionally sharing weights.
    """

    arch: str = "mlp"  # "mlp" | "cnn" | "lstm"
    vocab_size: int = 30_000  # letter-trigram hash dimension
    embed_width: int = 300  # output width of the sparse first layer
    hidden_dims: Tuple[int, ...] = (300,)  # dense layers between embed and semantic
    semantic_dim: int = 128  # final embedding dimension
    activation: str = "tanh"  # "tanh" | "relu"
    shared_weights: bool = True  # share tower weights between query and doc
    # CNN (CLSM) only: conv window over word sequence, feature maps
    conv_window: int = 3
    conv_channels: int = 300
    # LSTM only: hidden size of the recurrent cell
    lstm_hidden: int = 300
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core throughput
    # Storage dtype of the sparse first-layer table ONLY ("" = param_dtype).
    # "bfloat16" halves the table's footprint and gather bytes (updates use
    # stochastic rounding); "int8" quarters it against a per-row f32 scale.
    table_dtype: str = ""
    # int8 only: scale = init_row_absmax * headroom / 127 — the margin the
    # row may GROW during training before clipping at the grid edge.
    table_int8_headroom: float = 8.0

    @property
    def table_dtype_resolved(self) -> str:
        return self.table_dtype or self.param_dtype

    @property
    def is_sequence_model(self) -> bool:
        return self.arch in ("cnn", "lstm")


@dataclass(frozen=True)
class DataConfig(_Replaceable):
    """Input representation.

    A text is a fixed-length (indices[K], weights[K]) pair, padded with index
    0 / weight 0 (index 0 is reserved for padding by the trigram hasher).
    Sequence models use (indices[T, Kw], weights[T, Kw]) plus a word mask[T].
    """

    max_trigrams: int = 64  # K: nonzeros kept per text (bag-of-trigrams models)
    # K for the QUERY side only (0 = same as max_trigrams). Queries are much
    # shorter than titles, so a tighter query K shrinks the lookup work.
    max_trigrams_query: int = 0
    max_words: int = 16  # T: words kept per text (cnn/lstm)
    max_trigrams_per_word: int = 8  # Kw
    normalize_counts: bool = False  # l2-normalize trigram count vector
    # Per-batch index dedupe (data/dedupe.py): lookups become a compact
    # row-group gather + a lookup over the batch's unique rows.
    dedup_lookup: bool = True
    # U: compact rows per batch (static), gathered in row GROUPS (8 rows for
    # f32 tables), so budget ~8x the expected distinct-trigram count.
    max_unique: int = 8192
    # U2: exact unique-row slots (two-level dedupe).
    # Budget ~= the expected distinct-trigram count per batch.
    max_unique_rows: int = 1024
    # Third dedupe level (0 = off): re-slot each data shard's lookups into its
    # own slot space of this width. Budget ~= the distinct-trigram count of
    # ONE shard's rows.
    max_unique_rows_local: int = 0
    toy_vocab_words: int = 512  # toy dataset: word vocabulary size
    toy_num_pairs: int = 4096  # toy dataset: number of query-title pairs
    # File-backed corpus (data/corpus.py): .tsv/.txt ("query\ttitle" lines)
    # or .jsonl ({"query":..., "title":...}). Empty = the toy generator.
    path: str = ""
    eval_frac: float = 0.1  # held-out fraction for the eval split
    max_pairs: int = 0  # truncate the file corpus (0 = use all pairs)
    # Frequency-ordered vocab remap (data/remap.py): permute table rows so
    # Zipf-hot trigrams pack into dense row-group prefixes, which collapses
    # the per-batch unique GROUP count. Pure row permutation.
    freq_remap: bool = False
    # Host input-pipeline thread-pool width (0/1 = serial build).
    pipeline_workers: int = 0
    # Epoch shuffling. True (default): a fresh permutation per epoch.
    # False: every epoch replays the SAME (seed, 0) permutation (the
    # precondition for cache_epoch_batches).
    reshuffle_each_epoch: bool = True
    # Cache the host pipeline's finished batches during the first epoch and
    # replay them afterwards (requires reshuffle_each_epoch=False).
    cache_epoch_batches: bool = False
    seed: int = 0


@dataclass(frozen=True)
class LossConfig(_Replaceable):
    """Cosine-softmax loss over negatives.

    mode="in_batch": score the full [B, B'] similarity matrix; the diagonal
      (offset by the shard's global row offset) holds the positives.
    mode="rotate": each query is scored against its own doc plus
      `num_negatives` rotated copies of the doc batch.
    """

    mode: str = "in_batch"  # "in_batch" | "rotate"
    num_negatives: int = 50  # NEG, rotate mode only
    gamma: float = 20.0  # softmax smoothing γ


@dataclass(frozen=True)
class MeshConfig(_Replaceable):
    """Device mesh: ('data', 'model').

    data  — batch sharding + the axis the doc-embedding all-gather rides
    model — vocab-axis sharding of the trigram embedding table
            (1 disables embedding sharding).
    """

    data_parallel: int = -1  # -1: all remaining devices
    model_parallel: int = 1
    global_negatives: bool = True  # all-gather doc embeddings over 'data'
    # Wire dtype for the table-path collectives. "float32" keeps results
    # bit-exact against a single device.
    collective_dtype: str = "float32"  # "float32" | "bfloat16"


@dataclass(frozen=True)
class TrainConfig(_Replaceable):
    batch_size: int = 256  # global batch (split across 'data' axis)
    learning_rate: float = 0.1
    optimizer: str = "sgd"  # "sgd" | "momentum" | "adam"
    momentum: float = 0.9
    max_steps: int = 1000
    eval_every: int = 100
    log_every: int = 20
    checkpoint_every: int = 500
    keep_checkpoints: int = 3
    seed: int = 42
    # No use_pallas switch: the CUDA kernels take any width, so entry points
    # always run them on CUDA tensors (impl="auto").
    remat: bool = False  # recompute the towers in backward (trade FLOPs for memory)
    # Row-wise sparse table updates. Exact for SGD; momentum/adam use the
    # dense step regardless.
    sparse_embed_update: bool = True
    # Table-specific optimizer for the sparse path: "sgd" or "adagrad"
    # (row-wise AdaGrad, its accumulator kept in the table's spare
    # lane-padding column).
    table_optimizer: str = "sgd"
    table_adagrad_eps: float = 1e-6
    # Stochastic rounding for sub-f32 table updates (unbiased: the table
    # follows the f32 trajectory in expectation).
    table_stochastic_round: bool = True
    # Steps fused into one device dispatch. 1 = off.
    steps_per_call: int = 1
    # Max async dispatches in flight before the loop blocks on the oldest.
    max_inflight_steps: int = 4


@dataclass(frozen=True)
class IOConfig(_Replaceable):
    workdir: str = "/tmp/dssm_run"
    metrics_file: str = "metrics.jsonl"
    profile_dir: Optional[str] = None
    tensorboard: bool = False
    # Bins for per-weight histograms in the periodic weight summaries.
    # 0 = stats only.
    weight_histogram_bins: int = 0
    # Numeric sanitizer for debugging NaN/Inf; never on in production runs.
    debug_nans: bool = False


@dataclass(frozen=True)
class RunConfig(_Replaceable):
    name: str = "tiny"
    tower: TowerConfig = field(default_factory=TowerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    io: IOConfig = field(default_factory=IOConfig)


def _preset_tiny() -> RunConfig:
    """Tiny DSSM: 30k hash, 300-300-128 towers, batch 256, CPU-runnable."""
    return RunConfig(
        name="tiny",
        tower=TowerConfig(arch="mlp", vocab_size=30_000, embed_width=300,
                          hidden_dims=(300,), semantic_dim=128),
        train=TrainConfig(batch_size=256),
    )


def _preset_full() -> RunConfig:
    """Full DSSM: 500k trigram vocab, batch 1024 in-batch negatives."""
    return RunConfig(
        name="full",
        tower=TowerConfig(arch="mlp", vocab_size=500_000, embed_width=300,
                          hidden_dims=(300,), semantic_dim=128,
                          compute_dtype="bfloat16"),
        # max_unique=2048 rows (256 gather slots): sized for freq_remap,
        # which packs hot trigrams into dense group prefixes; the cap sizes
        # the gather output, so slack is pure cost. max_trigrams_query=32
        # covers the toy query side's longest text (docs need the full 64).
        data=DataConfig(toy_vocab_words=8192, toy_num_pairs=65536,
                        freq_remap=True, max_unique=2048,
                        max_trigrams_query=32),
        train=TrainConfig(batch_size=1024),
    )


def _preset_cnn() -> RunConfig:
    """CNN-DSSM (CLSM): conv towers + max-pool over trigram windows."""
    return RunConfig(
        name="cnn",
        tower=TowerConfig(arch="cnn", vocab_size=30_000, embed_width=300,
                          conv_window=3, conv_channels=300, semantic_dim=128,
                          compute_dtype="bfloat16"),
        train=TrainConfig(batch_size=1024),
    )


def _preset_lstm() -> RunConfig:
    """LSTM-DSSM: recurrent towers, final-state embeddings."""
    return RunConfig(
        name="lstm",
        tower=TowerConfig(arch="lstm", vocab_size=30_000, embed_width=300,
                          lstm_hidden=300, semantic_dim=128,
                          compute_dtype="bfloat16"),
        train=TrainConfig(batch_size=1024),
    )


def _preset_multihost() -> RunConfig:
    """Multi-host DSSM: sharded embedding + global negative pool via all-gather."""
    return RunConfig(
        name="multihost",
        tower=TowerConfig(arch="mlp", vocab_size=500_000, embed_width=300,
                          hidden_dims=(300,), semantic_dim=128,
                          compute_dtype="bfloat16"),
        data=DataConfig(toy_vocab_words=8192, toy_num_pairs=131072,
                        max_unique=16384, max_unique_rows=8192,
                        max_unique_rows_local=2048,
                        freq_remap=True, pipeline_workers=8,
                        # Fixed epoch order + epoch batch cache: the global
                        # dedupe runs once per batch, not once per epoch.
                        reshuffle_each_epoch=False,
                        cache_epoch_batches=True),
        # Vocab-sharded embedding table over 'model' + global negative pool
        # over 'data'.
        mesh=MeshConfig(data_parallel=-1, model_parallel=2,
                        global_negatives=True,
                        collective_dtype="bfloat16"),
        train=TrainConfig(batch_size=65536),
    )


PRESETS = {
    "tiny": _preset_tiny,
    "full": _preset_full,
    "cnn": _preset_cnn,
    "lstm": _preset_lstm,
    "multihost": _preset_multihost,
}


def validate(cfg: RunConfig) -> RunConfig:
    """Fail fast on invalid configs, at startup."""
    t, tr, d, l = cfg.tower, cfg.train, cfg.data, cfg.loss
    checks = [
        (t.arch in ("mlp", "cnn", "lstm"), f"tower.arch {t.arch!r}"),
        (t.activation in ("tanh", "relu"), f"tower.activation {t.activation!r}"),
        (tr.optimizer in ("sgd", "momentum", "adam"),
         f"train.optimizer {tr.optimizer!r}"),
        (tr.table_optimizer in ("sgd", "adagrad"),
         f"train.table_optimizer {tr.table_optimizer!r}"),
        (l.mode in ("in_batch", "rotate"), f"loss.mode {l.mode!r}"),
        (t.vocab_size > 1, f"tower.vocab_size {t.vocab_size}"),
        (tr.batch_size > 0, f"train.batch_size {tr.batch_size}"),
        (tr.steps_per_call >= 1, f"train.steps_per_call {tr.steps_per_call}"),
        (t.table_dtype in ("", "float32", "bfloat16", "int8"),
         f"tower.table_dtype {t.table_dtype!r}"),
    ]
    if t.table_dtype_resolved == "bfloat16":
        checks.append((d.dedup_lookup and tr.sparse_embed_update,
                       "tower.table_dtype='bfloat16' requires "
                       "data.dedup_lookup and train.sparse_embed_update "
                       "(stochastic-rounding updates run on the sparse "
                       "row-group path only)"))
    if t.table_dtype_resolved == "int8":
        checks.append((d.dedup_lookup and tr.sparse_embed_update,
                       "tower.table_dtype='int8' requires data.dedup_lookup "
                       "and train.sparse_embed_update (dequantized compact "
                       "path only)"))
        checks.append((tr.table_optimizer == "sgd",
                       "tower.table_dtype='int8' requires "
                       "table_optimizer='sgd' (the AdaGrad accumulator "
                       "column cannot live on the int8 grid)"))
        # int8 is the single-device capacity option; at model_parallel > 1
        # the bf16 sharded table already gives the same per-device size.
        checks.append((cfg.mesh.model_parallel == 1,
                       "tower.table_dtype='int8' is mp=1-only by design: "
                       "int8 is the single-chip capacity option; at mp>1 "
                       "the bf16 sharded table already provides the same "
                       "per-chip footprint (see decision note above)"))
        checks.append((t.shared_weights,
                       "tower.table_dtype='int8' requires shared_weights "
                       "(the dequantized union-dedupe path)"))
        checks.append((t.table_int8_headroom >= 1.0,
                       f"tower.table_int8_headroom {t.table_int8_headroom}"))
    checks.append((cfg.mesh.collective_dtype in ("float32", "bfloat16"),
                   f"mesh.collective_dtype {cfg.mesh.collective_dtype!r}"))
    checks.append((cfg.mesh.collective_dtype == "float32"
                   or tr.table_optimizer == "sgd",
                   "mesh.collective_dtype='bfloat16' requires "
                   "table_optimizer='sgd' (the AdaGrad accumulator column "
                   "rides the compact gather and would be bf16-rounded "
                   "every step)"))
    checks.append((not d.cache_epoch_batches or not d.reshuffle_each_epoch,
                   "data.cache_epoch_batches requires "
                   "reshuffle_each_epoch=False (the cached epoch-1 stream "
                   "must BE every later epoch's stream)"))
    if d.dedup_lookup:
        # Row-group alignment: 8 rows for f32 tables, 16 bf16, 32 int8.
        group = {4: 8, 2: 16, 1: 32}[
            __import__("numpy").dtype(t.table_dtype_resolved).itemsize
        ]
        checks.append((t.vocab_size % group == 0,
                       f"tower.vocab_size {t.vocab_size} must be a multiple "
                       f"of {group} with dedup_lookup (DMA row-group "
                       f"alignment for {t.table_dtype_resolved} tables)"))
        # max_unique is a row budget at f32 (8-row) granularity; the loader
        # scales it so the group-SLOT count (max_unique // 8) is constant
        # across table dtypes (data/loader.add_dedup_fields).
        checks.append((d.max_unique % 8 == 0,
                       f"data.max_unique {d.max_unique} must be a multiple "
                       "of 8"))
        checks.append(((d.max_unique // 8) * group <= t.vocab_size,
                       f"data.max_unique {d.max_unique} (x{group // 8} for "
                       f"{t.table_dtype_resolved} groups) must be <= "
                       f"vocab_size {t.vocab_size}"))
        # Dedupe pads unused slots with SKIP_SENTINEL_GID (1 << 25), which
        # must be out of range for every real group id.
        checks.append((t.vocab_size // group < (1 << 25),
                       f"tower.vocab_size {t.vocab_size} exceeds the dedupe "
                       f"skip-sentinel bound ({(1 << 25)} groups of {group})"))
    if tr.table_optimizer == "adagrad":
        checks.append((d.dedup_lookup and tr.sparse_embed_update,
                       "table_optimizer='adagrad' requires data.dedup_lookup "
                       "and train.sparse_embed_update"))
        # The per-row accumulator lives in the table's LAST lane-padding
        # column — the logical table width must not already fill the
        # 128-column padding, or it would overwrite a real weight column.
        logical_w = {"mlp": t.embed_width,
                     "cnn": t.conv_window * t.conv_channels,
                     "lstm": t.embed_width}[t.arch] if t.arch in (
                         "mlp", "cnn", "lstm") else 0
        checks.append((logical_w % 128 != 0,
                       f"table_optimizer='adagrad' needs a spare lane-padding "
                       f"column: logical table width {logical_w} is a "
                       f"multiple of 128 (widen/narrow tower.embed_width or "
                       f"conv dims by 1+)"))
    if l.mode == "rotate":
        checks.append((l.num_negatives < tr.batch_size,
                       f"loss.num_negatives {l.num_negatives} must be < "
                       f"batch_size {tr.batch_size}"))
    errors = [msg for ok, msg in checks if not ok]
    if errors:
        raise ValueError("invalid config: " + "; ".join(errors))
    return cfg


def get_preset(name: str) -> RunConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()


def apply_overrides(cfg: RunConfig, overrides: dict) -> RunConfig:
    """Apply dotted-key CLI overrides: {"train.learning_rate": 0.05}."""
    for key, value in overrides.items():
        parts = key.split(".")
        if len(parts) == 1:
            cfg = dataclasses.replace(cfg, **{parts[0]: value})
            continue

        def rebuild(obj, path, val):
            if len(path) == 1:
                fld = {f.name for f in dataclasses.fields(obj)}
                if path[0] not in fld:
                    raise KeyError(f"no field {path[0]!r} on {type(obj).__name__}")
                return dataclasses.replace(obj, **{path[0]: val})
            child = rebuild(getattr(obj, path[0]), path[1:], val)
            return dataclasses.replace(obj, **{path[0]: child})

        cfg = rebuild(cfg, parts, value)
    return cfg
