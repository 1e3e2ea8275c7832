"""The seven-benchmark evaluator of the port (twin of
``mllm_npu_tpu/evaluate`` and ``evaluate/run.py``): ``evaluator.EvalModel``
over a serving engine, the text benchmarks (MMLU, CMMLU, C-Eval, BBH),
the multimodal ones (MME, MM-Vet, SEED-Bench2) and ``run``, the CLI.
Nothing here imports pandas: ``table.read_csv`` reads the CSVs."""
