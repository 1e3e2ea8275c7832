"""The port's evaluator (``mllm_npu_tpu_torch.evaluate``) against the
reference's on the CPU: ``EvalModel.generate_text`` and
``generate_text_many`` on the tiny engines with the same weights (text
identical to JAX's, the batched prefix-cache engine equal to the serial
loop), ``lm_loss`` in fp32 on both assemblies within 1e-4 relative, the
seven benchmark functions on the fixtures (result bytes identical to the
JAX functions' on the same scripted models), the stdlib CSV reader against
``pandas.read_csv`` cell for cell, the ``run`` dispatcher and the speed
harness on the tiny stack, and the import and device rules."""

import copy
import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from mllm_npu_tpu.data.processor import ImageProcessor as JProc
from mllm_npu_tpu.evaluate import mm_benchmarks as jmm
from mllm_npu_tpu.evaluate import text_benchmarks as jtb
from mllm_npu_tpu.evaluate.evaluator import EvalModel as JEvalModel
from mllm_npu_tpu.serve.engine import InferenceEngine as JEngine
from mllm_npu_tpu.utils.testing import (FakeTokenizer as JTok,
                                        TinySpec as JSpec,
                                        build_tiny_mllm as j_build,
                                        synthetic_batch)
from mllm_npu_tpu_torch.data.processor import ImageProcessor
from mllm_npu_tpu_torch.evaluate import mm_benchmarks as tmm
from mllm_npu_tpu_torch.evaluate import run as trun
from mllm_npu_tpu_torch.evaluate import text_benchmarks as ttb
from mllm_npu_tpu_torch.evaluate.evaluator import EvalModel
from mllm_npu_tpu_torch.evaluate.table import NA_VALUES, read_csv
from mllm_npu_tpu_torch.serve.engine import (BatchedInferenceEngine,
                                             InferenceEngine)
from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
from mllm_npu_tpu_torch.utils.weights import from_jax_params
from test_torch_seedx import seed_pair

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
LOSS_RTOL = 1e-4
COMMON = dict(resolution_grids=("1x1", "1x2", "2x1"), base_resolution=448,
              num_img_in_tokens=4, num_img_out_tokens=4, max_new_tokens=4)


def _jax_engine(jm, jl, params, **kw):
    return JEngine(model=jm, lm_config=jl, params=params, tokenizer=JTok(),
                   image_transform=JProc(height=56, width=56),
                   cache_dtype=jnp.float32, **COMMON, **kw)


class _Jitted:
    """A flax module whose ``apply`` is jitted (the reference's EvalModel
    calls ``model.apply`` eagerly, several seconds a call on the CPU)."""
    def __init__(self, module):
        self.apply = jax.jit(module.apply)


def _port_engine(tm, cls=InferenceEngine, **kw):
    return cls(model=tm, tokenizer=FakeTokenizer(),
               image_transform=ImageProcessor(height=56, width=56),
               device="cpu", cache_dtype=torch.float32, **COMMON, **kw)


@pytest.fixture(scope="module")
def mllm_pair():
    """The reference's tiny comprehension assembly and its parameters, and
    the port's with the same weights (fp32)."""
    spec = JSpec(batch=1, seq=64, image_size=56, nq=4)
    jm, jl, _ = j_build(spec)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              **synthetic_batch(spec, cmp_images=1))
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu")
    tm.load_state_dict(from_jax_params(params["params"]), strict=True)
    return jm, jl, params, tm


@pytest.fixture(scope="module")
def text_models(mllm_pair):
    """EvalModels over the single-request engines of both packages."""
    jm, jl, params, tm = mllm_pair
    return (JEvalModel(_jax_engine(jm, jl, params)),
            EvalModel(_port_engine(copy.deepcopy(tm))))


PROMPTS = ["What is 2+2?\nA. 1\nB. 2\nC. 4\nD. 8\nAnswer:",
           "The following are multiple choice questions (with answers) "
           "about  algebra.\n\nFind x.\nA. 0\nB. 1\nAnswer: A\n\nFind y."
           "\nAnswer:",
           "以下是中国关于考试的单项选择题 答案:"]


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_generate_text_identical_to_reference(text_models, i):
    jem, tem = text_models
    for n in (4, 10):
        assert tem.generate_text(PROMPTS[i], max_new_tokens=n) == \
            jem.generate_text(PROMPTS[i], max_new_tokens=n)
    # the per-call budget left the shared generator's sampling alone
    assert tem.engine.generator.sampling.max_new_tokens == \
        COMMON["max_new_tokens"]
    assert not tem.supports_concurrent_text()


def _mmlu_dir(root: Path) -> Path:
    (root / "dev").mkdir(parents=True)
    (root / "test").mkdir()
    rows = [[f"What is {i}+{i}?", "1", "2", str(2 * i), "8", "C"]
            for i in range(6)]
    for sub, name in (("dev", "math_dev.csv"), ("test", "math_test.csv")):
        with open(root / sub / name, "w", newline="") as f:
            csv.writer(f, lineterminator="\n").writerows(rows)
    return root


def test_generate_text_many_prefix_cache_identical(mllm_pair, text_models,
                                                   tmp_path):
    """The subject's prompts at once through the port's batched engine with
    a prefix cache: the texts equal its serial loop's, the single engine's
    and JAX's; the result file equals the reference's bytes; the preamble
    hits the cache."""
    jm, jl, params, tm = mllm_pair
    jem, tem = text_models
    batched = EvalModel(_port_engine(
        copy.deepcopy(tm), BatchedInferenceEngine, num_slots=2, max_len=192,
        max_prompt=160, batch_prompt_bucket=16, prefix_cache=4))
    try:
        assert batched.supports_concurrent_text()
        root = _mmlu_dir(tmp_path / "mmlu")
        dev = read_csv(root / "dev" / "math_dev.csv", header=None)[:2]
        test = read_csv(root / "test" / "math_test.csv", header=None)
        head = ttb.gen_prompt_df(dev, "math", 2)
        prompts = [head + ttb.format_example_df(test, i, include_answer=False)
                   for i in range(4)]
        many = batched.generate_text_many(prompts, max_new_tokens=4)
        serial = [batched.generate_text(p, max_new_tokens=4)
                  for p in prompts]
        ref = [jem.generate_text(p, max_new_tokens=4) for p in prompts]
        assert many == serial == ref
        assert [tem.generate_text(p, max_new_tokens=4) for p in prompts] \
            == ref
        st_ = batched.engine.batch_engine.stats()["prefix_cache"]
        assert st_["hits"] >= 1 and st_["tokens_saved"] > 0, st_
        out_t, out_j = tmp_path / "port.json", tmp_path / "jax.json"
        ttb.mmlu_eval(batched, str(root), k=2, max_items_per_subject=3,
                      out_path=str(out_t))
        jtb.mmlu_eval(jem, str(root), k=2, max_items_per_subject=3,
                      out_path=str(out_j))
        assert out_t.read_bytes() == out_j.read_bytes()
    finally:
        batched.engine.close()


def _image(path: Path, w: int, h: int, seed: int) -> str:
    rs = np.random.RandomState(seed)
    Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(path)
    return str(path)


# (text, image sizes, max_length): one image; two images interleaved (the
# second wide, so two tiles); text only (the blank image); cut inside the
# question; cut inside the image's span (the reference's mask then pairs
# no span)
LOSS_CASES = {
    "one_image": ("<img>\nQuestion: what is it?\nAnswer: a dog",
                  [(60, 60)], 1024),
    "two_images": ("<img>first<img>\nQuestion: which differs?\nAnswer: "
                   "the second one", [(60, 60), (120, 50)], 1024),
    "text_only": ("Question: what is two plus two?\nAnswer: four", [], 1024),
    "truncated": ("<img>\nQuestion: " + " ".join(f"w{i}" for i in range(40))
                  + "\nAnswer: x", [(60, 60)], 20),
    "truncated_in_image": ("<img>\nQuestion: hm\nAnswer: a", [(60, 60)], 10),
}


def _loss_pair(tmp_path, jem, tem, case):
    text, sizes, max_length = LOSS_CASES[case]
    paths = [_image(tmp_path / f"{i}.png", w, h, i)
             for i, (w, h) in enumerate(sizes)]
    jem.max_length = tem.max_length = max_length
    if case.startswith("truncated"):
        assert len(tem.loss_inputs(text, paths)["input_ids"][0]) == max_length
    return tem.lm_loss(text, paths), jem.lm_loss(text, paths)


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_lm_loss_matches_reference(mllm_pair, tmp_path, case):
    jm, jl, params, tm = mllm_pair
    jem = JEvalModel(_jax_engine(jm, jl, params), model=_Jitted(jm),
                     params=params)
    tem = EvalModel(_port_engine(copy.deepcopy(tm)), model=tm)
    got, ref = _loss_pair(tmp_path, jem, tem, case)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)


@pytest.fixture(scope="module")
def seed_models():
    """The tiny SEED with the Qwen tower in both packages (fp32), each
    behind an engine for the tokenizer and the anyres settings."""
    jm, params, jl, tm = seed_pair("qwen")
    jem = JEvalModel(_jax_engine(jm, jl, params), model=_Jitted(jm),
                     params=params)
    tem = EvalModel(_port_engine(copy.deepcopy(tm)), model=tm)
    return jem, tem


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_seed_lm_loss_matches_reference(seed_models, tmp_path, case):
    """SEED's loss forward with no generation image: its rec_loss is 0 and
    the lm_loss the reference's."""
    jem, tem = seed_models
    got, ref = _loss_pair(tmp_path, jem, tem, case)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)
    text, sizes, _ = LOSS_CASES[case]
    paths = sorted(str(p) for p in tmp_path.glob("*.png"))
    batch = {k: torch.as_tensor(v)
             for k, v in tem.loss_inputs(text, paths).items()}
    with torch.no_grad():
        out = tem.model(**batch)
    assert float(out["rec_loss"]) == 0.0
    assert float(out["lm_loss"]) == pytest.approx(got, rel=1e-6)


def test_lm_loss_refuses_quantized_weights(mllm_pair, tmp_path):
    *_, tm = mllm_pair
    em = EvalModel(_port_engine(copy.deepcopy(tm), quantize_int8=True))
    with pytest.raises(ValueError, match="unconverted"):
        em.lm_loss("Question: hm\nAnswer: a", [])
    # given an unconverted model, it scores that one
    assert np.isfinite(EvalModel(em.engine, model=tm).lm_loss(
        "Question: hm\nAnswer: a", []))


# ---- the seven benchmarks on the fixtures, with scripted models ----------

class _ScriptedText:
    """Answers from the question's first words (the first answer that
    matches), recording every prompt."""
    def __init__(self, answers, default=None):
        self.answers, self.default, self.prompts = answers, default, []

    def generate_text(self, prompt, max_new_tokens=10):
        self.prompts.append(prompt)
        q = prompt.rsplit("\n\n", 1)[1]
        for start, a in self.answers.items():
            if q.startswith(start):
                return a
        if self.default is None:
            raise AssertionError(f"unexpected question: {q[:60]}")
        return self.default


class _ScriptedImage:
    def __init__(self, reply):
        self.reply, self.calls = reply, []

    def generate_with_image(self, prompt, img_path):
        assert os.path.exists(img_path)
        self.calls.append((prompt, os.path.basename(img_path)))
        return self.reply(prompt, img_path)


class _ScriptedLoss:
    def __init__(self):
        self.calls = []

    def lm_loss(self, text, data_paths):
        self.calls.append((text, [os.path.basename(p) for p in data_paths]))
        q, cand = text.split("\nAnswer: ", 1)
        q = q.split("Question: ", 1)[1]
        gt = {"What is shown in the image?": "a dog",
              "What color dominates?": "green"}[q]
        return 0.0 if cand == gt else 5.0 + len(cand)


def _mme_reply(prompt, img_path):
    if "one dog" in prompt or "outdoor" in prompt:
        return "Yes<img_00000>\n"
    return "No [something]"


def _mmvet_reply(prompt, img_path):
    if "v1_0" in img_path:
        return "The car is red.<img_00001> [ref]"
    return "There are 2 people."


TEXT_ANSWERS = {
    "mmlu": {"The cyclic subgroup": " A", "What is the order": " B",
             "Compute the product": " C", "How many homomorphisms": " B"},
    "cmmlu": {"种子萌发": " C", "果树嫁接": " B", "覆盖地膜": " B",
              "测定土壤": " B"},
    "ceval": {"DNS的主要作用": " B", "UDP相比TCP": " B", "交换机工作": " B"},
    "bbh": {"Question: ( True or False )": " False"},
}


def _run_benchmark(name, pkg_t, pkg_m, out):
    """One benchmark of one package (its text or mm module) on the fixture
    → (scripted model, result path)."""
    if name in TEXT_ANSWERS:
        model = _ScriptedText(TEXT_ANSWERS[name],
                              "True it is" if name == "bbh" else None)
        fn = getattr(pkg_t, f"{name}_eval")
        fn(model, str(FIXTURES / name), k=5, out_path=str(out))
    elif name == "mme":
        model = _ScriptedImage(_mme_reply)
        pkg_m.mme_eval(model, str(FIXTURES / "mme"), out_dir=str(out))
    elif name == "mmvet":
        model = _ScriptedImage(_mmvet_reply)
        pkg_m.mm_vet_eval(model, str(FIXTURES / "mmvet"), out_path=str(out))
    else:
        model = _ScriptedLoss()
        pkg_m.seed_bench2_eval(model, str(FIXTURES / "seed_bench2"),
                               out_path=str(out), level="L2")
    return model


def _tree_bytes(path: Path) -> dict:
    if path.is_dir():
        return {p.name: p.read_bytes() for p in sorted(path.iterdir())}
    return {path.name: path.read_bytes()}


@pytest.mark.parametrize("name", ["mmlu", "cmmlu", "ceval", "bbh", "mme",
                                  "mmvet", "seed_bench2"])
def test_benchmark_result_bytes_identical_to_reference(name, tmp_path):
    out_t = tmp_path / "port" / "res"
    out_j = tmp_path / "jax" / "res"
    out_t.parent.mkdir()
    out_j.parent.mkdir()
    mt = _run_benchmark(name, ttb, tmm, out_t)
    mj = _run_benchmark(name, jtb, jmm, out_j)
    assert _tree_bytes(out_t) == _tree_bytes(out_j)
    assert _tree_bytes(out_t)
    if name in TEXT_ANSWERS:
        assert mt.prompts == mj.prompts and mt.prompts
        golden = (FIXTURES / name / "golden_prompt_item0.txt").read_text()
        assert mt.prompts[0] == golden
    else:
        assert mt.calls == mj.calls and mt.calls


# ---- the CSV reader against pandas ---------------------------------------

def _assert_same_cells(path, header):
    kw = {} if header == "infer" else {"header": None}
    got, ref = read_csv(path, header=header), pd.read_csv(path, **kw)
    assert got.shape == ref.shape
    assert [str(c) for c in got.columns] == [str(c) for c in ref.columns]
    for i in range(ref.shape[0]):
        for j in range(ref.shape[1]):
            assert str(got.iloc[i, j]) == str(ref.iloc[i, j]), (i, j)
            assert "{}".format(got.iloc[i, j]) == "{}".format(ref.iloc[i, j])


@pytest.mark.parametrize("path", [
    "mmlu/dev/abstract_algebra_dev.csv", "mmlu/test/abstract_algebra_test.csv",
    "cmmlu/dev/agronomy.csv", "cmmlu/test/agronomy.csv",
    "ceval/dev/computer_network_dev.csv",
    "ceval/test/computer_network_test.csv"])
def test_csv_reader_matches_pandas_on_fixtures(path):
    _assert_same_cells(FIXTURES / path,
                       None if path.startswith("mmlu") else "infer")


_digits = st.integers(-10 ** 12, 10 ** 12)
CELLS = st.one_of(
    _digits.map(str),
    _digits.map(lambda n: f"{n:+d}"), _digits.map(lambda n: f"00{abs(n)}"),
    _digits.map(lambda n: f" {n} "),
    st.decimals(-10 ** 6, 10 ** 6, places=4, allow_nan=False).map(str),
    st.floats(-1e9, 1e9, allow_nan=False).map(lambda x: f"{x:.6g}"),
    st.floats(allow_nan=False).map(repr),
    st.floats(allow_nan=False, allow_infinity=False).map(
        lambda x: f"{x:.20e}"),
    st.sampled_from(sorted(NA_VALUES)),
    st.sampled_from(["True", "false", "TRUE", "tRuE", "True ", " false",
                     "inf", "-Infinity", "1.e5", ".5", "5.", "1e+", "1_0",
                     "0x10", "NAN", "nan ", "yes"]),
    st.text(st.characters(codec="utf-8",
                          exclude_characters="\r\n\x00﻿"),
            max_size=8),
    st.sampled_from(["光合作用", "答案: B", "a, b", 'say "hi"', "x,\"y\"",
                     "线粒体,叶绿体", "  "]))


def _columns(n_rows):
    # each column draws from one kind of cell, or mixes them
    return st.lists(st.one_of(
        st.lists(CELLS, min_size=n_rows, max_size=n_rows),
        st.lists(_digits.map(str) | st.sampled_from(["", "NA", "nan"]),
                 min_size=n_rows, max_size=n_rows),
        # int64's whole range
        st.lists(st.integers(-2 ** 63, 2 ** 63 - 1).map(str),
                 min_size=n_rows, max_size=n_rows),
        st.lists(st.sampled_from(["True", "False", "", "true"]),
                 min_size=n_rows, max_size=n_rows),
        st.lists(st.decimals(-100, 100, places=2, allow_nan=False).map(str)
                 | st.just(""), min_size=n_rows, max_size=n_rows)),
        min_size=2, max_size=5)


@settings(max_examples=40, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(data=st.data(), header=st.sampled_from(["infer", None]))
def test_csv_reader_matches_pandas_on_generated_cells(tmp_path, data,
                                                      header):
    """Numbers (signs, leading zeros, padding, decimals, exponents), NA
    strings, booleans, quotes, commas, CJK text, mixed in columns and
    written with ``csv`` (quoted where needed) as a CSV, with or without a
    header row: every cell's ``str()`` equals pandas'."""
    n_rows = data.draw(st.integers(1, 6))
    cols = data.draw(_columns(n_rows))
    rows = [list(r) for r in zip(*cols)]
    # a row pandas would skip as blank is not what these cells test
    rows = [r for r in rows if any(c.strip() for c in r)]
    if not rows:
        return
    if header == "infer":
        rows.insert(0, [f"c{j}" for j in range(len(cols))])
        if len(rows) == 1:
            return
    path = tmp_path / "t.csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)
    _assert_same_cells(path, header)


def _float_cells(rs, n):
    """Cells for the float converter: every exponent from -330 to 310,
    mantissas of 1 to 25 digits, leading zeros, signs, whitespace around
    and after the ``e``, and strings of its characters at random."""
    def digits(k):
        return "".join(rs.choice(list("0123456789"), k))
    cells = ["3.16617e-64", "0.0000000000000000000000123", "1e 3", "1e +3",
             "1e+ 3", "1e", "1e+", ".", "5.", ".5", "-0.0e5", "-0e400",
             "1e-700", "-1e-700", "-123e-330", "9e308", "-1e309", "4.9e-324",
             "1e000000000000000001", "1e9223372036854775808", "-.5e-3"]
    for i in range(n):
        kind = i % 4
        if kind == 0:
            cells.append(f"{rs.choice(['', '-', '+'])}{digits(rs.randint(1, 26))}"
                         f"e{rs.randint(-330, 311)}")
        elif kind == 1:
            cells.append(f"{digits(rs.randint(0, 12))}.{digits(rs.randint(0, 26))}"
                         f"E{rs.choice(['', '-', '+'])}{rs.randint(0, 40)}")
        elif kind == 2:
            cells.append(repr(float(rs.standard_normal()
                                    * 10.0 ** rs.randint(-300, 300))))
        else:
            cells.append("".join(rs.choice(list("0123456789.eE+- "),
                                           rs.randint(1, 11))))
    return [c for c in cells if c.strip()]


def test_csv_reader_float_converter_matches_pandas(tmp_path):
    """Each cell a column of its own (so each is typed alone): the cell's
    value equals pandas', where pandas' converter is not correctly rounded
    and where it takes a cell for text."""
    cells = _float_cells(np.random.RandomState(0), 3000)
    path = tmp_path / "f.csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f, lineterminator="\n").writerow(cells)
    got, ref = read_csv(path, header=None), pd.read_csv(path, header=None)
    assert got.shape == ref.shape == (1, len(cells))
    got = [got.iloc[0, j] for j in range(len(cells))]
    ref = [ref[j].iloc[0] for j in range(len(cells))]
    for cell, g, r in zip(cells, got, ref):
        assert (str(g), type(g) is str) == (str(r), type(r) is str), cell
    assert {type(v) for v in got} == {int, float, str}


def test_csv_reader_pandas_quirks(tmp_path):
    """A first data row one field longer than the header makes an index;
    empty and repeated names; short rows padded with NA; blank lines."""
    path = tmp_path / "q.csv"
    path.write_text(",A,A,\n0,x,1.50,7\n1,y,2,\n\n2,z,,NA\n")
    _assert_same_cells(path, "infer")
    path.write_text("A,B,C\n1,x\n2,u,v\n   \n3,w,True\n")
    _assert_same_cells(path, "infer")
    assert read_csv(path)[["C", "A"]].iloc[0, 1] == 1


# ---- run.py's twin, the speed harness, and the rules ---------------------

YAML_8B = "mllm_npu_tpu_torch/configs/models/mllm_llama3_8b_siglip_vit.yaml"
YAML_SEEDX = ("mllm_npu_tpu_torch/configs/models/"
              "seedx_llama2_13b_qwenvl_vitg.yaml")


@pytest.mark.parametrize("yaml,dataset,data", [
    (YAML_8B, "mmlu", "mmlu"), (YAML_SEEDX, "seed_bench", "seed_bench2")])
def test_run_dispatches_on_the_tiny_stack(monkeypatch, tmp_path, yaml,
                                          dataset, data):
    """``python -m mllm_npu_tpu_torch.evaluate.run`` on a shipped YAML
    under DEBUG_FLAG (tiny components, FakeTokenizer) with --device cpu:
    the benchmark's result file in the working directory."""
    monkeypatch.setenv("DEBUG_FLAG", "True")
    monkeypatch.chdir(tmp_path)
    res = trun.main(["--config_path", str(REPO / yaml), "--dataset_name",
                     dataset, "--data_path", str(FIXTURES / data),
                     "--max_items", "2", "--device", "cpu"])
    if dataset == "mmlu":
        assert set(json.loads(Path("result_mmlu.json").read_text())) == {
            "abstract_algebra", "average"}
    else:
        answers, _ = res
        lines = Path("results.json").read_text().splitlines()
        assert [json.loads(x) for x in lines] == answers
        assert [a["question_id"] for a in answers] == ["q_000001",
                                                       "q_000002"]


def test_run_dispatches_mme_and_mmvet(monkeypatch, tmp_path):
    """The image benchmarks through the dispatcher on the tiny SEED-X
    stack (4 new tokens an answer)."""
    monkeypatch.setenv("DEBUG_FLAG", "True")
    monkeypatch.chdir(tmp_path)
    em = trun.build_eval_model(str(REPO / YAML_SEEDX), max_new_tokens=4,
                               device="cpu")
    assert trun.dispatch(em, "mme", str(FIXTURES / "mme"), 1) == {
        "count": 1, "scene": 1}
    assert (tmp_path / "res_mme" / "scene.txt").read_text().startswith(
        "0002.jpg\tIs this an indoor scene?\tNo\t")
    assert list(trun.dispatch(em, "mm_vet", str(FIXTURES / "mmvet"))) == [
        "v1_0", "v1_1"]
    assert json.loads(Path("res_mmvet.json").read_text()).keys() == {
        "v1_0", "v1_1"}


def test_run_refuses_checkpoints_and_keeps_the_prompt_cap(monkeypatch,
                                                          tmp_path):
    """An orbax params directory (the JAX package's) raises, naming queue 1
    item 16, and so does a path that is no directory."""
    monkeypatch.setenv("DEBUG_FLAG", "True")
    orbax = tmp_path / "orbax" / "checkpoint_0"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="item 16"):
        trun.build_eval_model(str(REPO / YAML_8B), device="cpu",
                              params_checkpoint=str(orbax.parent))
    with pytest.raises(FileNotFoundError):
        trun.build_eval_model(str(REPO / YAML_8B), device="cpu",
                              params_checkpoint=str(tmp_path / "some_dir"))
    em = trun.build_eval_model(str(REPO / YAML_8B), max_new_tokens=2,
                               prefix_cache=2, device="cpu")
    try:
        eng = em.engine.batch_engine
        assert (eng.B, eng.max_len, eng.max_prompt) == (2, 2560, 2048)
        # the reference's cap: a prompt past max_prompt raises
        with pytest.raises(ValueError, match="exceeds"):
            em.generate_text(" ".join(["w"] * 2100), max_new_tokens=2)
    finally:
        em.engine.close()
    with pytest.raises(ValueError, match="unknown dataset"):
        trun.dispatch(em, "nope", ".")


def test_evaluator_imports_no_jax_no_reference_no_pandas():
    code = (
        "import sys\n"
        "import mllm_npu_tpu_torch.evaluate\n"
        "import mllm_npu_tpu_torch.evaluate.run\n"
        "import mllm_npu_tpu_torch.evaluate.evaluator\n"
        "import mllm_npu_tpu_torch.evaluate.text_benchmarks\n"
        "import mllm_npu_tpu_torch.evaluate.mm_benchmarks\n"
        "import mllm_npu_tpu_torch.bench_eval_speed\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mllm_npu_tpu', 'pandas')]\n"
        "print('BAD', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_entry_points_raise_without_gpu(monkeypatch):
    from mllm_npu_tpu_torch import bench_eval_speed as bes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DEBUG_FLAG", "True")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--config_path", str(REPO / YAML_8B)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bes.main(["--preset", "tiny"])
    with pytest.raises(SystemExit):
        bes.parse_args(["--preset", "8b"])     # needs --int8 or --int4


@pytest.mark.parametrize("extra", [[], ["--prefix_cache", "4", "--slots",
                                        "2"]], ids=["single", "prefix"])
def test_bench_eval_speed_tiny_on_cpu(capsys, extra):
    from mllm_npu_tpu_torch import bench_eval_speed as bes
    bes.main(["--preset", "tiny", "--device", "cpu", "--mmlu_items", "3",
              "--mme_images", "1", "--unroll"] + extra)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["preset"] == "tiny" and out["unroll"] is True
    assert out["mmlu"]["items"] == 3 and out["mme"]["qa_pairs"] == 2
    for key in ("steady_items_per_sec", "projected_full_mmlu_hours",
                "first2_with_compile_s"):
        assert out["mmlu"][key] > 0
    assert out["mme"]["steady_qa_per_sec"] > 0
    if extra:
        assert out["prefix_cache"]["hits"] > 0
        assert out["prefix_cache"]["tokens_saved"] > 0
