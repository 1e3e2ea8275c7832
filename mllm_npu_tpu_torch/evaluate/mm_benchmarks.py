"""Multimodal benchmarks: MME / MM-Vet / SEED-Bench2 (the port's copy of
``mllm_npu_tpu/evaluate/mm_benchmarks.py``), with the same result files,
byte for byte (res_mme/*.txt, res_mmvet.json, results.json)."""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

import numpy as np

from mllm_npu_tpu_torch.evaluate.evaluator import strip_special

log = logging.getLogger(__name__)

MME_PROMPT = ("You are a helpful assistant. Generate a short and concise "
              "response to the following image text pair. "
              "Question: {} Answer: ")


def mme_eval(model, data_path, out_dir="res_mme", max_items=None):
    """MME layout: data_path/<task>/ with images + '<name>.txt' question
    files, two questions per image; answers written one line per QA pair
    (reference mme.py:91-157)."""
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    results = {}
    for task in sorted(os.listdir(data_path)):
        task_dir = os.path.join(data_path, task)
        if not os.path.isdir(task_dir):
            continue
        log.info("task %s starting ...", task)
        lines = []
        qa_dir = (os.path.join(task_dir, "questions_answers_YN")
                  if os.path.isdir(os.path.join(task_dir,
                                                "questions_answers_YN"))
                  else task_dir)
        img_dir = (os.path.join(task_dir, "images")
                   if os.path.isdir(os.path.join(task_dir, "images"))
                   else task_dir)
        count = 0
        for qf in sorted(os.listdir(qa_dir)):
            if not qf.endswith(".txt"):
                continue
            base = qf[:-4]
            img_path = None
            for ext in (".jpg", ".png", ".jpeg"):
                cand = os.path.join(img_dir, base + ext)
                if os.path.exists(cand):
                    img_path = cand
                    break
            if img_path is None:
                continue
            with open(os.path.join(qa_dir, qf)) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) < 2:
                        continue
                    question, gt = parts[0], parts[1]
                    if max_items is not None and count >= max_items:
                        break
                    pred = model.generate_with_image(
                        MME_PROMPT.format(question), img_path)
                    pred = strip_special(pred).replace("\n", " ").strip()
                    # reference line format (mme.py:112-121): the IMAGE
                    # file name (with extension), then the original
                    # question\tgt pair, then the prediction
                    img_name = os.path.basename(img_path)
                    lines.append(f"{img_name}\t{question}\t{gt}\t{pred}")
                    count += 1
        if lines:   # reference writes only non-empty tasks (mme.py:153)
            out_file = Path(out_dir) / f"{task}.txt"
            out_file.write_text("\n".join(lines))
            results[task] = len(lines)
    return results


def mm_vet_eval(model, data_path, out_path="res_mmvet.json",
                max_items=None):
    """MM-Vet: data_path/mm-vet.json + images/; writes {v1_i: answer}
    (reference mm_vet.py)."""
    image_folder = os.path.join(data_path, "images")
    with open(os.path.join(data_path, "mm-vet.json")) as f:
        data = json.load(f)
    results = {}
    for i in range(len(data)):
        if max_items is not None and i >= max_items:
            break
        qid = f"v1_{i}"
        item = data[qid]
        img_path = os.path.join(image_folder, item["imagename"])
        # reference mm_vet.py:68: the bare assistant sentence — its
        # .format(question) is vestigial (no placeholder), so the
        # question reaches the model only through conversation handling
        # upstream; kept byte-exact
        pred = model.generate_with_image(
            "You are a helpful assistant. Generate a short and concise "
            "response to the following image text pair.", img_path)
        # reference mm_vet.py:98-101: the two regex strips only, no
        # whitespace trim; file written with indent=4
        results[qid] = strip_special(pred)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=4)
    return results


# ---------------------------------------------------------------------------
# SEED-Bench2
# ---------------------------------------------------------------------------

def filter_questions(data, level="L2", subpart="all", version="v2"):
    """(reference seed_bench2.py:241-273)."""
    levels = {"L1": ["L1"], "L2": ["L1", "L2"],
              "L3": ["L1", "L2", "L3"]}[level]
    data = [q for q in data if q["level"] in levels]
    all_subparts = ["Single-Image & Text Comprehension",
                    "Multiple-Images & Text Comprehension",
                    "Video & Text Comprehension",
                    "Interleaved Image & Text Comprehension",
                    "Image Generation", "Image & Text Generation"]
    subparts = all_subparts if subpart == "all" else [subpart]
    data = [q for q in data if q["subpart"] in subparts]
    versions = {"v1": ["v1"], "v2": ["v1", "v2"]}[version]
    return [q for q in data if q["version"] in versions]


def rank_choices(model, question: str, choices: list[str],
                 data_paths: list[str]) -> int:
    """Rank candidate answers by LM loss; return argmin index
    (reference seed_bench2.py:65-234, argmin :302-304)."""
    losses = []
    for cand in choices:
        text = "Question: {}\nAnswer: {}".format(question, cand)
        n_imgs = len(data_paths)
        text = "<img>" * (n_imgs - text.count("<img>")) + text \
            if n_imgs > 1 else "<img>\n" + text
        losses.append(model.lm_loss(text, data_paths))
    return int(np.argsort(losses)[0])


def seed_bench2_eval(model, data_path, out_path="results.json",
                     level="L2", subpart="all", version="v2",
                     cc3m_dir="cc3m-image", seed_bench_v2_dir="seed_bench_v2",
                     max_items=None):
    with open(os.path.join(data_path, "SEED-Bench_v2_level1_2_3.json")) as f:
        qa_anno = json.load(f)["questions"]
    qa_anno = filter_questions(qa_anno, level, subpart, version)
    answers = []
    correct = 0
    with open(out_path, "a") as out_f:
        for step, qa in enumerate(qa_anno):
            if max_items is not None and step >= max_items:
                break
            img_root = os.path.join(
                data_path, cc3m_dir if qa["data_source"] == "cc3m"
                else seed_bench_v2_dir)
            data_id = qa["data_id"]
            paths = ([os.path.join(img_root, p) for p in data_id]
                     if isinstance(data_id, list)
                     else [os.path.join(img_root, data_id)])
            choices = [qa["choice_a"], qa["choice_b"], qa["choice_c"],
                       qa["choice_d"]]
            pred = "ABCD"[rank_choices(model, qa["question"], choices,
                                       paths)]
            rec = {"question_id": qa["question_id"], "prediction": pred}
            answers.append(rec)
            out_f.write(json.dumps(rec) + "\n")
            if pred == qa.get("answer"):
                correct += 1
    acc = correct / max(len(answers), 1)
    log.info("seed-bench2 accuracy %.4f over %d", acc, len(answers))
    return answers, acc
