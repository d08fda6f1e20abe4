"""The recipe layer of the port (the counterparts of the repo's ``tools/``):
the synthetic-corpus generators, the CI scorer, the train-log summary, and
the hard-corpus training and evaluation recipes above ``train.main`` and
``infer.infer``.

- ``make_synth_corpus``: the Kaldi feature corpus (``--hard``: the BPE-unit
  corpus of the hard recipes), byte-equal to ``tools/make_synth_corpus.py``;
- ``make_synth_waves``: the raw-wave corpus of wav2vec 2.0 pretraining;
- ``score_ci``: token error with utterance-level bootstrap CIs, single and
  paired;
- ``summarize_run``: a ``train.log``'s valid losses and throughput;
- ``run_hard``: ``tools/run_hard.sh`` (u2, transducer, paraformer);
- ``eval_hard``: ``tools/eval_hard.sh``, ``eval_hard_td.sh``,
  ``eval_hard_pf.sh`` and ``eval_streaming.sh`` as one entry point.
"""
