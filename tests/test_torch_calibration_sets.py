"""Port parity for the calibration data layer: the formatters give the same
messages (or the same error) as the JAX package's on the rows of
``tests/test_formatters.py``; the calibration-set configs validate and
refuse alike; the cache keys are equal, character for character; sets
built from ``tests/fixtures`` hold the same rows in the same order
(shuffled with the same seed), tokenize the same, and a cache written by
either package is found and read by the other. All comparisons are exact.
"""

import os

import pytest

from quantizers_tpu.data import calibration_sets as jc
from quantizers_tpu.data import formatters as jf
from quantizers_tpu_torch.data import calibration_sets as tc
from quantizers_tpu_torch.data import formatters as tf

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fx(name: str) -> str:
    return os.path.join(FIXTURES, name)


def _outcome(fn, *args, **kw):
    """The result of a call, or its exception type and message."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # the refusals are compared, not raised
        return ("raised", type(exc).__name__, str(exc))


_CHAT = [{"role": "user", "content": "u"}, {"role": "assistant", "content": "a"}]
_TOOLACE = {"sys": "tools available",
            "conv": [{"from": "user", "value": "call it"}, {"from": "assistant", "value": "{}"},
                     {"from": "tool", "value": "{\"ok\":1}"}]}
_CONTEST = {"whole": {"description": "Count pairs.",
                      "solutions": {"solution": ["print(1)", "print(2)"]}}}

#: (formatter, columns, row, kwargs): the cases of tests/test_formatters.py
FORMATTER_CASES = {
    "sharegpt_roles": ("sharegpt", ["conv"], {"conv": [
        {"from": "system", "value": "sys"}, {"from": "human", "value": "hi"},
        {"from": "gpt", "value": "hello"}]}, {}),
    "sharegpt_unknown_sender": ("sharegpt", ["c"], {"c": [{"from": "alien", "value": "x"}]}, {}),
    "sharegpt_invalid_entries": ("sharegpt", ["c"], {"c": [
        "not-a-dict", {"from": "human"}, {"from": "gpt", "value": "ok"}]}, {}),
    "sharegpt_column_count": ("sharegpt", ["a", "b"], {}, {}),
    "sharegpt_missing_column": ("sharegpt", ["missing"], {"other": []}, {}),
    "sharegpt_empty": ("sharegpt", ["c"], {"c": []}, {}),
    "prompt_answer": ("prompt_answer", ["q", "a"], {"q": "Q?", "a": "A."}, {}),
    "prompt_answer_names": ("prompt_answer", ["instruction", "output"],
                            {"instruction": "do", "output": "did"}, {}),
    "prompt_answer_empty_prompt": ("prompt_answer", ["q", "a"], {"q": "", "a": "A."}, {}),
    "prompt_answer_empty_answer": ("prompt_answer", ["q", "a"], {"q": "Q?", "a": ""}, {}),
    "prompt_answer_column_count": ("prompt_answer", ["only_one"], {}, {}),
    "chat_passthrough": ("chat_completion", ["m"], {"m": _CHAT}, {}),
    "chat_reasoning": ("chat_completion", ["m"], {"m": [
        {"role": "user", "content": "u"},
        {"role": "assistant", "content": "ans", "reasoning_content": "because"}]}, {}),
    "chat_none_reasoning": ("chat_completion", ["m"], {"m": [
        {"role": "assistant", "content": "a", "reasoning_content": None}]}, {}),
    "chat_reasoning_on_user": ("chat_completion", ["m"], {"m": [
        {"role": "user", "content": "u", "reasoning_content": "r"}]}, {}),
    "chat_column_count": ("chat_completion", [], {}, {}),
    "sysprompt_toolace": ("chat_completion_with_sysprompt", ["sys", "conv"], _TOOLACE, {}),
    "sysprompt_role_content": ("chat_completion_with_sysprompt", ["s", "c"],
                               {"s": None, "c": [{"role": "user", "content": "hi"}]}, {}),
    "sysprompt_unknown_roles": ("chat_completion_with_sysprompt", ["s", "c"], {"s": "", "c": [
        {"from": "narrator", "value": "skip"}, {"from": "user", "value": "ok"}]}, {}),
    "sysprompt_column_count": ("chat_completion_with_sysprompt", ["one"], {}, {}),
    "raw_text": ("raw_text", ["text"], {"text": "lorem"}, {}),
    "raw_text_prefix": ("raw_text", ["t"], {"t": "body"}, {"prefix": "Write in French:"}),
    "raw_text_empty_prefix": ("raw_text", ["t"], {"t": "body"}, {"prefix": ""}),
    "raw_text_column_count": ("raw_text", ["a", "b"], {}, {}),
    "contests": ("deepmind_code_contests", ["whole"], _CONTEST, {}),
    "contests_string_column": ("deepmind_code_contests", ["name"], {
        "name": "prob-1", "description": "Desc here.", "solutions": {"solution": ["s"]}}, {}),
    "contests_no_solutions": ("deepmind_code_contests", ["d"], {
        "d": {"description": "only desc", "solutions": {"solution": []}}}, {}),
    "contests_column_count": ("deepmind_code_contests", [], {}, {}),
}


@pytest.mark.parametrize("case", sorted(FORMATTER_CASES))
def test_formatters_give_the_same_messages(case):
    name, columns, row, kw = FORMATTER_CASES[case]
    got = _outcome(tf.get_formatter(name), columns, row, **kw)
    assert got == _outcome(jf.get_formatter(name), columns, row, **kw)


def test_formatter_registry_is_the_same():
    assert tf.available_formatters() == jf.available_formatters()
    assert _outcome(tf.get_formatter, "nope") == _outcome(jf.get_formatter, "nope")
    assert tf.DatasetFmt.get_formatter("sharegpt") is tf.DatasetFmt.sharegpt


def _entry(**kw):
    base = dict(dataset=fx("qa_pairs"), formatter="prompt_answer", split="train",
                columns=["question", "answer"], num_samples=2)
    base.update(kw)
    return base


#: DatasetEntryConfig.from_dict inputs of tests/test_calibration_sets.py
ENTRY_DICTS = {
    "valid": _entry(),
    "missing_dataset": {"formatter": "raw_text", "split": "train", "columns": ["x"],
                        "num_samples": 1},
    "missing_split": {"dataset": "d", "formatter": "raw_text", "columns": ["x"],
                      "num_samples": 1},
    "missing_formatter": {"dataset": "d", "split": "train", "columns": ["x"], "num_samples": 1},
    "missing_num_samples": {"dataset": "d", "split": "train", "formatter": "raw_text",
                            "columns": ["x"]},
    **{f"bad_num_samples_{b!r}": _entry(num_samples=b) for b in (0, -3, "some", 1.5, True)},
    "all": _entry(num_samples="all"),
    "columns_not_a_list": _entry(columns="x"),
    "columns_empty": _entry(columns=[]),
    "template_modulus_bad": _entry(formatter="raw_text", columns=["text"], formatter_params={
        "prefix": "{{ ['a', 'b'][hash(row|string) % 5] }}"}),
    "template_modulus_ok": _entry(formatter="raw_text", columns=["text"], formatter_params={
        "prefix": "{{ ['a', 'b', 'c', 'd', 'e'][hash(row|string) % 5] }}"}),
}


def _entry_outcome(mod, d):
    out = _outcome(mod.DatasetEntryConfig.from_dict, d)
    return out if out[0] == "raised" else ("ok", vars(out[1]))


@pytest.mark.parametrize("case", sorted(ENTRY_DICTS))
def test_entry_configs_validate_the_same(case):
    assert _entry_outcome(tc, ENTRY_DICTS[case]) == _entry_outcome(jc, ENTRY_DICTS[case])


def test_sample_budgets_resolve_the_same():
    class NoLen:
        def __len__(self):
            raise TypeError

    for kw, data in (({"num_samples": 500}, list(range(7))), ({"num_samples": "all"},
                     list(range(9))), ({"num_samples": "all", "streaming": True}, NoLen())):
        got = tc.DatasetEntryConfig(**_entry(**kw)).resolve_num_samples("d", data)
        assert got == jc.DatasetEntryConfig(**_entry(**kw)).resolve_num_samples("d", data)


SET_DICTS = {
    "no_root_key": {"datasets": []},
    "defaults": {"calibration_set": {"datasets": [
        {"dataset": "d", "split": "train", "formatter": "raw_text", "columns": ["x"],
         "num_samples": 1}]}},
    "missing_file": "/nonexistent/x.yaml",
    "quick": "configs/calibration_sets/test-calibrate_quick.yaml",
    "diverse_columns": fx("t_calibrate_diverse_columns.yaml"),
}


def _set_outcome(mod, d):
    out = _outcome(mod.CalibrationSetConfig.from_dict, d)
    if out[0] == "raised":
        return out
    cfg = out[1]
    return ("ok", cfg.max_seq_length, cfg.shuffle, cfg.seed, [vars(e) for e in cfg.datasets],
            _outcome(cfg.validate), mod.CalibrationSet.compute_cache_key(cfg))


@pytest.mark.parametrize("case", sorted(SET_DICTS))
def test_set_configs_load_and_key_the_same(case):
    assert _set_outcome(tc, SET_DICTS[case]) == _set_outcome(jc, SET_DICTS[case])


def _key_cfgs(mod):
    def cfg(**kw):
        base = dict(max_seq_length=1024, shuffle=True, seed=1,
                    datasets=[mod.DatasetEntryConfig(**_entry())])
        base.update(kw)
        return mod.CalibrationSetConfig(**base)

    plain = _entry(dataset=fx("plain_text"), formatter="raw_text", columns=["text"])
    return [cfg(), cfg(seed=2), cfg(datasets=[mod.DatasetEntryConfig(**_entry(num_samples=3))]),
            cfg(datasets=[mod.DatasetEntryConfig(**_entry(num_samples="all"))]),
            cfg(datasets=[mod.DatasetEntryConfig(**_entry()), mod.DatasetEntryConfig(**plain)]),
            cfg(datasets=[mod.DatasetEntryConfig(**plain), mod.DatasetEntryConfig(**_entry())]),
            mod.CalibrationSetConfig()]


def test_cache_keys_are_equal():
    got = [_outcome(tc.CalibrationSet.compute_cache_key, c) for c in _key_cfgs(tc)]
    want = [_outcome(jc.CalibrationSet.compute_cache_key, c) for c in _key_cfgs(jc)]
    assert got == want
    assert got[0][1].endswith("-2.parquet") and "length_TBD" in got[3][1]
    assert got[4] == got[5]  # the key ignores the entries' order


class MockTokenizer:
    """Fixed-output tokenizer (tests/test_calibration_sets.py's)."""

    def apply_chat_template(self, messages, tokenize=False):
        return " \n".join(f"<{m['role']}>{m['content']}" for m in messages)

    def __call__(self, text, padding=False, max_length=None, truncation=True,
                 add_special_tokens=False):
        ids = [ord(c) % 1000 for c in text][: max_length or 16]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}


#: (shuffle, seed, entries) of the consolidation cases
BUILDS = {
    "one_entry": (False, 42, [_entry()]),
    "three_entries_shuffled": (True, 3, [
        _entry(), _entry(dataset=fx("plain_text"), formatter="raw_text", columns=["text"],
                         num_samples=3),
        _entry(dataset=fx("sharegpt_conv"), formatter="sharegpt", columns=["conversations"],
               num_samples=4)]),
    "capped": (True, 42, [_entry(num_samples=100)]),
    "jinja_prefix": (False, 42, [_entry(
        dataset=fx("plain_text"), formatter="raw_text", columns=["text"], num_samples=3,
        formatter_params={"prefix": "Answer in {{ ['French', 'German'][hash(row|string) % 2] }}:"})]),
    "static_prefix": (False, 42, [_entry(dataset=fx("plain_text"), formatter="raw_text",
                                         columns=["text"], num_samples=1,
                                         formatter_params={"prefix": "Fixed:"})]),
    "toolace": (False, 42, [_entry(dataset=fx("toolace_style"),
                                   formatter="chat_completion_with_sysprompt",
                                   columns=["system", "conversations"], num_samples=2)]),
}


def _build(mod, case, cache_dir):
    shuffle, seed, entries = BUILDS[case]
    cfg = mod.CalibrationSetConfig(shuffle=shuffle, seed=seed, max_seq_length=8,
                                   datasets=[mod.DatasetEntryConfig(**e) for e in entries])
    return mod.CalibrationSet.from_config(cfg, cache_dir=str(cache_dir))


def _hashed(rows):
    """Rows with a prefix drawn by ``hash(row|string)``: Python's string
    hash is seeded per process, and HF ``datasets`` may reuse a mapped
    table that another process cached, so each row's prefix is one of the
    template's choices (in both packages alike) and the rest is compared."""
    assert all(r[0]["content"] in ("Answer in French:", "Answer in German:") for r in rows)
    return [r[1:] for r in rows]


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_fixture_sets_hold_the_same_rows(case, tmp_path):
    got, want = _build(tc, case, tmp_path / "t"), _build(jc, case, tmp_path / "j")
    assert got.total_num_samples == want.total_num_samples > 0
    rows = [list(s._untokenized_calibration_set["formatted"]) for s in (got, want)]
    if case == "jinja_prefix":
        assert _hashed(rows[0]) == _hashed(rows[1])
        return
    assert rows[0] == rows[1]
    assert (list(got.get_tokenized(MockTokenizer())["input_ids"])
            == list(want.get_tokenized(MockTokenizer())["input_ids"]))
    got_b = list(got.iter_token_batches(MockTokenizer(), batch_size=2, pad_to=8))
    want_b = list(want.iter_token_batches(MockTokenizer(), batch_size=2, pad_to=8))
    assert [(a.tolist(), m.tolist()) for a, m in got_b] == [(a.tolist(), m.tolist())
                                                            for a, m in want_b]


def test_run_config_quick_set_is_the_same_in_order(tmp_path):
    """The repository's quick set (shuffle, seed 42), as do_oneshot builds
    it, gives the same rows in the same order in both packages."""
    from quantizers_tpu.config import load_quantization_config as jload
    from quantizers_tpu_torch.config import load_quantization_config as tload

    run = tmp_path / "run.yaml"
    run.write_text("model:\n  name: m\nquantization:\n  recipe: r.yaml\n"
                   f"calibration_set: {ROOT}/configs/calibration_sets/"
                   "test-calibrate_quick.yaml\n")
    got = tc.CalibrationSet.from_config(tload(str(run)).calibration_set_config,
                                        cache_dir=str(tmp_path / "t"))
    want = jc.CalibrationSet.from_config(jload(str(run)).calibration_set_config,
                                         cache_dir=str(tmp_path / "j"))
    assert got.total_num_samples == 11
    assert (list(got._untokenized_calibration_set["formatted"])
            == list(want._untokenized_calibration_set["formatted"]))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_cache_written_by_one_package_is_read_by_the_other(writer, tmp_path):
    mods = {"jax": jc, "torch": tc}
    built = _build(mods[writer], "three_entries_shuffled", tmp_path)
    built.save_to_cache()
    reader = tc if writer == "jax" else jc
    cfg = reader.CalibrationSetConfig(shuffle=True, seed=3, max_seq_length=8, datasets=[
        reader.DatasetEntryConfig(**e) for e in BUILDS["three_entries_shuffled"][2]])
    assert reader.CalibrationSet.is_cached(cfg, str(tmp_path))
    loaded = reader.CalibrationSet.from_cache(cfg, cache_dir=str(tmp_path))
    assert (list(loaded._untokenized_calibration_set["formatted"])
            == list(built._untokenized_calibration_set["formatted"]))


def test_guards_refuse_alike(tmp_path):
    for mod in (jc, tc):
        cfg = mod.CalibrationSetConfig(datasets=[mod.DatasetEntryConfig(**_entry())])
        with pytest.raises(RuntimeError, match="from_config"):
            mod.CalibrationSet(cfg)
        with pytest.raises(RuntimeError, match="not loaded"):
            mod.CalibrationSet(cfg, str(tmp_path), _from_factory=True).get_tokenized(
                MockTokenizer())
        with pytest.raises(FileNotFoundError, match="is_cached"):
            mod.CalibrationSet.from_cache(cfg, cache_dir=str(tmp_path / "empty"))
