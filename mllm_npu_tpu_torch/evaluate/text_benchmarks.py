"""Text benchmarks: MMLU / CMMLU / C-Eval / BBH (the port's copy of
``mllm_npu_tpu/evaluate/text_benchmarks.py``: 5-shot prompts, letter match,
the same result files, byte for byte). The CSVs are read by
:func:`mllm_npu_tpu_torch.evaluate.table.read_csv`, which gives every cell
the value ``pandas.read_csv`` gives it, so prompts and results are the
reference's bytes without pandas."""

from __future__ import annotations

import json
import logging
import os
import numpy as np

from mllm_npu_tpu_torch.evaluate.table import read_csv

log = logging.getLogger(__name__)

CHOICES = ["A", "B", "C", "D"]


def format_subject(subject: str) -> str:
    return "".join(" " + e for e in subject.split("_"))


# ---------------------------------------------------------------------------
# MMLU / CMMLU (headerless CSV: question, A, B, C, D, answer)
# ---------------------------------------------------------------------------

def format_example_df(df, idx, include_answer=True,
                      chinese=False) -> str:
    prompt = str(df.iloc[idx, 0])
    k = df.shape[1] - 2
    for j in range(k):
        prompt += "\n{}. {}".format(CHOICES[j], df.iloc[idx, j + 1])
    # the Chinese benchmarks end examples with 答案: (reference
    # cmmlu.py:15 / ceval.py:15), the English ones with Answer:
    prompt += "\n答案:" if chinese else "\nAnswer:"
    if include_answer:
        prompt += " {}\n\n".format(df.iloc[idx, k + 1])
    return prompt


def gen_prompt_df(train_df, subject, k=-1, chinese=False) -> str:
    # exact reference bytes — mmlu.py:30 has "about {}" PLUS
    # format_subject's leading space (double space); cmmlu.py:30 puts the
    # subject after the parenthetical
    if chinese:
        head = ("以下是关于的多项选择题(含答案) {}.\n\n"
                .format(format_subject(subject)))
    else:
        head = ("The following are multiple choice questions (with answers)"
                " about {}.\n\n".format(format_subject(subject)))
    if k == -1:
        k = train_df.shape[0]
    return head + "".join(
        format_example_df(train_df, i, chinese=chinese) for i in range(k))


def _eval_subject_df(model, subject, dev_df, test_df, chinese=False,
                     k=5, max_items=None):
    n = test_df.shape[0] if max_items is None else min(max_items,
                                                       test_df.shape[0])
    train_prompt = gen_prompt_df(dev_df, subject, k, chinese=chinese)
    prompts = [train_prompt + format_example_df(test_df, i,
                                                include_answer=False,
                                                chinese=chinese)
               for i in range(n)]
    labels = [str(test_df.iloc[i, test_df.shape[1] - 1])
              for i in range(n)]
    # batched engines decode a subject's items CONCURRENTLY (slots
    # share one verify batch; greedy rows are order-independent so
    # results are identical to the serial loop — parity-tested)
    texts = (model.generate_text_many(prompts, max_new_tokens=10)
             if hasattr(model, "generate_text_many")
             and model.supports_concurrent_text()
             else [model.generate_text(p, max_new_tokens=10)
                   for p in prompts])
    # reference compares output['text'][1] to the label letter
    # (mmlu.py:60-61): first decoded char after the leading space
    cors = [t.strip()[:1] == lab for t, lab in zip(texts, labels)]
    acc = float(np.mean(cors)) if cors else 0.0
    log.info("Average accuracy %.3f - %s", acc, subject)
    return np.asarray(cors), acc


def mmlu_eval(model, data_path, k=5, max_items_per_subject=None,
              out_path="result_mmlu.json"):
    subjects = sorted(f.split("_test.csv")[0]
                      for f in os.listdir(os.path.join(data_path, "test"))
                      if "_test.csv" in f)
    results = {}
    for subject in subjects:
        dev_df = read_csv(
            os.path.join(data_path, "dev", subject + "_dev.csv"),
            header=None)[:k]
        test_df = read_csv(
            os.path.join(data_path, "test", subject + "_test.csv"),
            header=None)
        _, acc = _eval_subject_df(model, subject, dev_df, test_df, k=k,
                                  max_items=max_items_per_subject)
        results[subject] = acc
    results["average"] = float(np.mean(list(results.values())))
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    return results


def cmmlu_eval(model, data_path, k=5, max_items_per_subject=None,
               out_path="result_cmmlu.json"):
    subjects = sorted(f.split(".csv")[0]
                      for f in os.listdir(os.path.join(data_path, "test"))
                      if f.endswith(".csv"))
    results = {}
    for subject in subjects:
        dev_df = read_csv(os.path.join(data_path, "dev",
                                       subject + ".csv"))[:k]
        test_df = read_csv(os.path.join(data_path, "test",
                                        subject + ".csv"))
        # CMMLU CSVs have headers; drop the index column if present
        dev_df = dev_df[dev_df.columns[-6:]]
        test_df = test_df[test_df.columns[-6:]]
        _, acc = _eval_subject_df(model, subject, dev_df, test_df,
                                  chinese=True, k=k,
                                  max_items=max_items_per_subject)
        results[subject] = acc
    results["average"] = float(np.mean(list(results.values())))
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    return results


def ceval_eval(model, data_path, k=5, max_items_per_subject=None,
               out_path="result_ceval.json"):
    """C-Eval: test split has no labels; write the site-submission JSON
    (reference ceval.py:77)."""
    subjects = sorted(f.split("_test.csv")[0]
                      for f in os.listdir(os.path.join(data_path, "test"))
                      if f.endswith(".csv"))
    all_result = {}
    for subject in subjects:
        dev_df = read_csv(os.path.join(data_path, "dev",
                                       subject + "_dev.csv"))
        test_df = read_csv(os.path.join(data_path, "test",
                                        subject + "_test.csv"))
        preds = {}
        n = test_df.shape[0] if max_items_per_subject is None else \
            min(max_items_per_subject, test_df.shape[0])
        few = dev_df[:k]
        cols = [c for c in ("question", "A", "B", "C", "D")
                if c in test_df.columns]
        # reference ceval.py:30 bytes
        train_prompt = ("以下是中国关于{}考试的单项选择题，请选出其中的正确"
                        "答案。\n\n").format(format_subject(subject))
        # reference ceval.py:11-18 example bytes (named columns, 答案:)
        for i in range(min(k, few.shape[0])):
            train_prompt += str(few.iloc[i]["question"])
            for c in "ABCD":
                train_prompt += f"\n{c}. {few.iloc[i][c]}"
            train_prompt += "\n答案: {}\n\n".format(
                few.iloc[i].get("answer", ""))
        for i in range(n):
            row = test_df.iloc[i]
            prompt = train_prompt + str(row["question"])
            for c in "ABCD":
                prompt += f"\n{c}. {row[c]}"
            prompt += "\n答案:"
            text = model.generate_text(prompt, max_new_tokens=10)
            # submission keyed by ROW INDEX (reference ceval.py:60
            # res_s[str(i)]), value = the predicted letter
            preds[str(i)] = text.strip()[:1]
        all_result[subject] = preds
    with open(out_path, "w") as f:
        json.dump(all_result, f)
    return all_result


# ---------------------------------------------------------------------------
# BBH (json tasks: {"examples": [{"input", "target"}, ...]})
# ---------------------------------------------------------------------------

def format_example_bbh(data, idx, include_answer=True) -> str:
    prompt = "Question: {}\nAnswer:".format(data["examples"][idx]["input"])
    if include_answer:
        prompt += " {}\n\n".format(data["examples"][idx]["target"])
    return prompt


def bbh_eval(model, data_path, k=5, max_items_per_subject=None,
             out_path="result_bbh.json"):
    subjects = sorted(f.split(".json")[0]
                      for f in os.listdir(os.path.join(data_path, "data"))
                      if f.endswith(".json"))
    results = {}
    for subject in subjects:
        with open(os.path.join(data_path, "data", subject + ".json")) as f:
            data = json.load(f)
        # reference bbh.py:23 — "about {}" + format_subject's leading
        # space gives a double space, kept byte-exact
        train_prompt = ("The following are questions (with answers) "
                        "about {}.\n\n".format(format_subject(subject)))
        train_prompt += "".join(format_example_bbh(data, i)
                                for i in range(k))
        cors = []
        hi = len(data["examples"])
        if max_items_per_subject is not None:
            hi = min(hi, k + max_items_per_subject)
        for i in range(k, hi):
            prompt = train_prompt + format_example_bbh(data, i,
                                                       include_answer=False)
            label = str(data["examples"][i]["target"])
            text = model.generate_text(prompt, max_new_tokens=10)
            cors.append(label in text[:len(label) + 2])
        acc = float(np.mean(cors)) if cors else 0.0
        log.info("Average accuracy %.3f - %s", acc, subject)
        results[subject] = acc
    results["average"] = float(np.mean(list(results.values())))
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    return results
