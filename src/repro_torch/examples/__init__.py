"""The port's runnable examples, one module per example of the reference
(``examples/*.py``), each run as ``python -m repro_torch.examples.<name>``
with the reference's flags plus ``--device`` (default ``cuda``):

  * ``quickstart``      — the shared backbone, three zero-copy functions,
                          a batched multi-adapter ``generate`` and a
                          two-policy simulation;
  * ``serve_multilora`` — warm functions behind the adaptive batching
                          scheduler, over ``InferenceEngine.generate``;
  * ``serve_continuous`` — a bursty shared-prefix trace through the
                          continuous-batching runtime;
  * ``train_lora``      — pretraining, LoRA fine-tuning and the two
                          checkpoints;
  * ``serverless_sim``  — all five policies over the paper's three
                          traffic patterns;
  * ``paper_setup``     — the paper's evaluation setup (§6.1) those use.

Each splits into ``main(argv=None)``, which parses the flags and draws the
seeded weights and inputs, and a work function that takes the config, the
weights, the draws and, where the example reads a clock, the clock, prints
the reference's lines and returns a report dict.
"""
