"""The reproduction pipeline of the port: ``train.sh``, ``predict.sh``,
``rehearsal.sh`` and the rehearsal's synthetic corpus (``synth_corpus``)."""
