"""Calibration-set engine: YAML-declared dataset mixes with deterministic
Parquet caching.

Re-implements the reference's L3 layer (``src/quantizers/calibration_sets.py``)
with the same YAML schema, cache-key format and late-bound tokenization
design:

* a calibration set is a list of dataset entries, each naming an HF dataset,
  split, columns, a formatter and a sample budget;
* ``formatter_params`` values may be Jinja templates evaluated per row with a
  restricted set of Python builtins (deterministic prompt diversification,
  e.g. per-row language injection via ``hash(row|string) % N``);
* the consolidated, *untokenized* set is cached to Parquet under a key
  derived only from the config — one cache serves any tokenizer
  (design rationale mirrored from reference ``calibration_sets.py:256-276``);
* tokenization (chat template + truncation to ``max_seq_length``) is a
  separate step, :meth:`CalibrationSet.get_tokenized`.

Counterpart of ``quantizers_tpu/data/calibration_sets.py``: the same cache
key, rows and order (a cache built by one package is found and read by the
other). HF ``datasets`` is imported inside the functions that load, map or
cache a set, so that importing this module does not load it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import re
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Union

import yaml
from jinja2 import Environment, StrictUndefined

from .formatters import get_formatter

log = logging.getLogger(__name__)

#: When a streaming entry asks for "all" samples we cannot know the length;
#: fall back to this budget (reference: STREAMING_DEFAULT_SAMPLE_LIMIT = 256).
STREAMING_DEFAULT_SAMPLE_LIMIT = 256

_JINJA_BUILTINS = {
    "hash": hash,
    "len": len,
    "abs": abs,
    "max": max,
    "min": min,
    "sum": sum,
    "sorted": sorted,
    "enumerate": enumerate,
    "zip": zip,
}

_TEMPLATE_MARKERS = ("{{", "}}")


def _looks_templated(value: Any) -> bool:
    return isinstance(value, str) and all(m in value for m in _TEMPLATE_MARKERS)


def _make_jinja_env() -> Environment:
    env = Environment(undefined=StrictUndefined, autoescape=True)
    env.globals.update(_JINJA_BUILTINS)
    return env


def _check_template_modulus(template: str) -> None:
    """Static check: a ``[...][hash(row|string) % N]`` template must index a
    list with at least N elements, otherwise it can raise at runtime.
    Performed at config-load time (reference behavior,
    ``calibration_sets.py:131-152``)."""
    mod = re.search(r"\[hash\(row\|string\)\s*%\s*(\d+)\]", template)
    if not mod:
        return
    modulus = int(mod.group(1))
    lst = re.search(r"(\[.*?\])\s*\[hash\(row\|string\)\s*%\s*\d+\]", template)
    if not lst:
        return
    items = [p.strip() for p in lst.group(1).strip("[]").split(",") if p.strip()]
    if len(items) < modulus:
        raise ValueError(
            f"List index error: Template has list with {len(items)} elements "
            f"but uses modulus {modulus}, which can cause index errors at runtime."
        )


@dataclasses.dataclass
class DatasetEntryConfig:
    """One dataset entry of a calibration set.

    Required: ``dataset``, ``formatter``, ``columns``, ``num_samples``
    (positive int or ``"all"``), ``split``. Optional: ``subset``,
    ``streaming``, ``formatter_params``.
    """

    dataset: str
    formatter: str
    split: str = "train"
    subset: Optional[str] = None
    columns: List[str] = dataclasses.field(default_factory=list)
    num_samples: Optional[Union[int, str]] = None
    streaming: bool = False
    formatter_params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.columns = list(self.columns or [])
        self.formatter_params = dict(self.formatter_params or {})
        self.validate()

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "DatasetEntryConfig":
        if not data.get("dataset"):
            raise ValueError("Dataset is required in calibration entry")
        if not data.get("split"):
            raise ValueError("Split is required in calibration entry")
        if not data.get("formatter"):
            raise ValueError("formatter is required in calibration entry")

        columns = data.get("columns", [])
        if not isinstance(columns, list):
            raise ValueError(f"columns must be a list, got {type(columns)}")

        n = data.get("num_samples")
        if n is None:
            raise ValueError("num_samples is required in calibration entry")
        if not (n == "all" or (isinstance(n, int) and not isinstance(n, bool) and n > 0)):
            raise ValueError("num_samples must be a positive integer or 'all'")

        return cls(
            dataset=data["dataset"],
            formatter=data["formatter"],
            split=data["split"],
            subset=data.get("subset"),
            columns=columns,
            num_samples=n,
            streaming=bool(data.get("streaming", False)),
            formatter_params=data.get("formatter_params", {}) or {},
        )

    def validate(self) -> None:
        if not self.dataset:
            raise ValueError("Dataset is required in calibration entry")
        if not self.split:
            raise ValueError("Split is required in calibration entry")
        if self.num_samples is None:
            raise ValueError("num_samples is required in calibration entry")
        n = self.num_samples
        if not (n == "all" or (isinstance(n, int) and not isinstance(n, bool) and n > 0)):
            raise ValueError("num_samples must be a positive integer or 'all'")
        if not self.columns:
            raise ValueError("columns list cannot be empty")
        if not self.formatter:
            raise ValueError("formatter is required in calibration entry")
        for value in self.formatter_params.values():
            if _looks_templated(value):
                _check_template_modulus(value)

    def resolve_num_samples(self, dataset_name: str, dataset: Any) -> int:
        """Resolve the sample budget against the actual dataset size."""
        try:
            available: Optional[int] = len(dataset)
        except TypeError:  # streaming IterableDataset
            available = None

        if self.num_samples == "all":
            if available is not None:
                wanted = available
            else:
                wanted = STREAMING_DEFAULT_SAMPLE_LIMIT
                log.info(
                    "Using default sample count of %d for streaming dataset %s "
                    "('all' requested but length unknown)",
                    wanted,
                    dataset_name,
                )
        else:
            wanted = int(self.num_samples or 0)

        if available is not None and wanted > available:
            log.warning(
                "Requested %d samples from %s, but only %d available. "
                "Using all available samples.",
                wanted,
                dataset_name,
                available,
            )
            return available
        return wanted


@dataclasses.dataclass
class CalibrationSetConfig:
    """Whole-set spec: sequence policy + shuffling + dataset entries."""

    max_seq_length: int = 4096
    shuffle: bool = True
    seed: int = 42
    datasets: List[DatasetEntryConfig] = dataclasses.field(default_factory=list)

    @classmethod
    def from_dict(cls, data: Union[str, Dict[str, Any]]) -> "CalibrationSetConfig":
        if isinstance(data, str):
            return cls.from_file(data)
        if "calibration_set" not in data:
            raise ValueError("Configuration must have 'calibration_set' key at the root level")
        body = data["calibration_set"]
        return cls(
            max_seq_length=body.get("max_seq_length", 4096),
            shuffle=body.get("shuffle", True),
            seed=body.get("seed", 42),
            datasets=[DatasetEntryConfig.from_dict(e) for e in body.get("datasets", [])],
        )

    @classmethod
    def from_file(cls, path: str) -> "CalibrationSetConfig":
        p = Path(path)
        if not p.exists():
            raise ValueError(f"Calibration set not found: {path}")
        with open(p) as f:
            data = yaml.safe_load(f) or {}
        if "calibration_set" not in data:
            raise ValueError(f"Calibration set file must have 'calibration_set' key: {path}")
        return cls.from_dict(data)

    def validate(self) -> None:
        if not self.datasets:
            raise ValueError("Calibration set must have at least one dataset")
        for entry in self.datasets:
            entry.validate()


# ---------------------------------------------------------------------------
# consolidation helpers (module-level so they stay testable in isolation)
# ---------------------------------------------------------------------------

def _load_hf_dataset(entry: DatasetEntryConfig):
    from datasets import load_dataset

    name = entry.dataset if isinstance(entry.dataset, str) else entry.dataset[0]
    kwargs: Dict[str, Any] = {"split": entry.split, "streaming": entry.streaming}
    if entry.subset is not None:
        return load_dataset(name, entry.subset, **kwargs)  # nosec B615
    return load_dataset(name, **kwargs)  # nosec B615


def _format_entry(entry: DatasetEntryConfig) -> Any:
    """Load, sample-limit and format one dataset entry.

    Returns a ``Dataset`` with a single ``formatted`` column holding message
    lists.
    """
    from datasets import Dataset

    dataset = _load_hf_dataset(entry)
    budget = entry.resolve_num_samples(entry.dataset, dataset)

    if entry.num_samples != "all":
        dataset = dataset.filter(lambda _row, i: i < budget, with_indices=True)

    fmt = get_formatter(entry.formatter)
    env = _make_jinja_env()
    static_params = {k: v for k, v in entry.formatter_params.items() if not _looks_templated(v)}
    templated = {k: env.from_string(v) for k, v in entry.formatter_params.items() if _looks_templated(v)}

    def convert(row: Dict[str, Any]) -> Dict[str, Any]:
        params = dict(static_params)
        for key, template in templated.items():
            try:
                params[key] = template.render(row=row)
            except Exception:
                log.error("Failed to render Jinja template for param %r", key)
                raise
        messages = fmt(entry.columns, row, **params) if params else fmt(entry.columns, row)
        return {"formatted": messages}

    dataset = dataset.map(convert, remove_columns=dataset.column_names)

    if entry.streaming:
        take_n = budget if entry.num_samples != "all" else STREAMING_DEFAULT_SAMPLE_LIMIT
        rows = list(dataset.take(take_n))
        return Dataset.from_dict({"formatted": [r["formatted"] for r in rows]})

    if isinstance(entry.num_samples, int) and len(dataset) > entry.num_samples:
        dataset = dataset.select(range(entry.num_samples))
    return dataset


class CalibrationSet:
    """A consolidated, cacheable calibration dataset.

    Construct through :meth:`from_config` (build from raw data) or
    :meth:`from_cache` (load the Parquet cache); direct construction raises.
    The stored dataset is always *untokenized* — call :meth:`get_tokenized`
    with a tokenizer to produce ``input_ids``.
    """

    def __init__(
        self,
        config: CalibrationSetConfig,
        cache_dir: str = "./cache",
        _from_factory: bool = False,
    ):
        if not _from_factory:
            raise RuntimeError(
                "CalibrationSet should not be instantiated directly. "
                "Use CalibrationSet.from_config() or CalibrationSet.from_cache() instead."
            )
        self.config = config
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._untokenized_calibration_set: Optional[Any] = None  # a datasets.Dataset

    # ---- cache management --------------------------------------------------

    @staticmethod
    def compute_cache_key(config: CalibrationSetConfig) -> str:
        """Deterministic cache file name: ``<7-hex>-<total_samples>.parquet``.

        The key covers only what changes the consolidated data: each entry's
        identity (dataset/split/subset/samples/columns/formatter) plus the
        set-level seq-length/shuffle/seed.
        """
        entries = sorted(
            (
                [e.dataset, e.split, e.subset, e.num_samples, list(e.columns), e.formatter]
                for e in config.datasets
            ),
            key=lambda item: (item[0], item[1], str(item[2])),
        )
        canonical = json.dumps(
            {
                "datasets": entries,
                "max_seq_length": config.max_seq_length,
                "shuffle": config.shuffle,
                "seed": config.seed,
            },
            sort_keys=True,
        )
        digest = hashlib.sha256(canonical.encode()).hexdigest()[:7]

        total: Union[int, str] = 0
        for e in config.datasets:
            if e.num_samples == "all":
                total = "length_TBD"
                break
            if isinstance(e.num_samples, int) and e.num_samples > 0:
                total += e.num_samples
            else:
                raise ValueError(f"Invalid sample count in dataset {e.dataset}: {e.num_samples}")
        return f"{digest}-{total}.parquet"

    @staticmethod
    def is_cached(config: CalibrationSetConfig, cache_dir: str = "./cache") -> bool:
        config.validate()
        return (Path(cache_dir) / CalibrationSet.compute_cache_key(config)).exists()

    @classmethod
    def from_cache(cls, config: CalibrationSetConfig, cache_dir: str = "./cache") -> "CalibrationSet":
        from datasets import Dataset

        config.validate()
        inst = cls(config, cache_dir, _from_factory=True)
        cache_path = inst.cache_dir / cls.compute_cache_key(config)
        if not cache_path.exists():
            raise FileNotFoundError(
                f"Cache not found for configuration. Use CalibrationSet.is_cached() to check "
                f"before loading, or CalibrationSet.from_config() to build from raw data. "
                f"Expected cache file: {cache_path}"
            )
        try:
            log.info("Loading from cache: %s", cache_path)
            dataset = Dataset.from_parquet(str(cache_path))
            if len(dataset) == 0:
                raise ValueError(f"Cache found but empty: {cache_path}")
            inst._untokenized_calibration_set = dataset
        except Exception as exc:
            raise RuntimeError(f"Failed to load cache file {cache_path}: {exc}") from exc
        return inst

    @classmethod
    def from_config(cls, config: CalibrationSetConfig, cache_dir: str = "./cache") -> "CalibrationSet":
        config.validate()
        inst = cls(config, cache_dir, _from_factory=True)
        inst._consolidate_datasets()
        return inst

    def save_to_cache(self) -> None:
        if self._untokenized_calibration_set is None:
            raise RuntimeError(
                "No calibration dataset to save. Ensure dataset is available before calling save_to_cache()."
            )
        if len(self._untokenized_calibration_set) == 0:
            log.warning("Cannot save empty dataset to cache")
            return
        cache_path = self.cache_dir / self.compute_cache_key(self.config)
        try:
            log.info("Saving to cache: %s", cache_path)
            self._untokenized_calibration_set.to_parquet(str(cache_path))
        except Exception:
            log.error("Failed to save cache file %s", cache_path)

    # ---- consolidation & tokenization ---------------------------------------

    def _consolidate_datasets(self) -> Any:
        from datasets import concatenate_datasets

        parts = [_format_entry(entry) for entry in self.config.datasets]
        if not parts:
            raise ValueError("No datasets were processed - this should not happen")
        merged = concatenate_datasets(parts)
        if self.config.shuffle:
            merged = merged.shuffle(seed=self.config.seed)
        self._untokenized_calibration_set = merged
        return merged

    def get_tokenized(self, tokenizer) -> Any:
        """Tokenize the consolidated set: chat template + truncation, no
        padding, no extra special tokens."""
        if self._untokenized_calibration_set is None:
            raise RuntimeError(
                "Calibration dataset is not loaded. "
                "Use CalibrationSet.from_cache() with cached data or "
                "CalibrationSet.from_config() to build from raw data."
            )

        max_len = self.config.max_seq_length

        def tokenize_row(row: Dict[str, Any]) -> Dict[str, Any]:
            text = tokenizer.apply_chat_template(row["formatted"], tokenize=False)
            return tokenizer(
                text,
                padding=False,
                max_length=max_len,
                truncation=True,
                add_special_tokens=False,
            )

        return self._untokenized_calibration_set.map(
            tokenize_row,
            batched=False,
            remove_columns=self._untokenized_calibration_set.column_names,
        )

    @property
    def total_num_samples(self) -> int:
        if self._untokenized_calibration_set is None:
            return 0
        return len(self._untokenized_calibration_set)

    def iter_token_batches(
        self, tokenizer, batch_size: int, pad_to: Optional[int] = None
    ) -> Iterable[Any]:
        """Yield right-padded ``(input_ids, mask)`` numpy batches for the
        calibration forward pass (static shapes)."""
        import numpy as np

        tokenized = self.get_tokenized(tokenizer)
        ids = [row["input_ids"] for row in tokenized]
        target = pad_to or max((len(x) for x in ids), default=0)
        for start in range(0, len(ids), batch_size):
            chunk = ids[start : start + batch_size]
            batch = np.zeros((len(chunk), target), dtype=np.int32)
            mask = np.zeros((len(chunk), target), dtype=np.bool_)
            for j, seq in enumerate(chunk):
                seq = seq[:target]
                batch[j, : len(seq)] = seq
                mask[j, : len(seq)] = True
            yield batch, mask
