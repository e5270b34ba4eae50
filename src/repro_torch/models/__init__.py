"""The LM model stack (port of ``repro.models``): dense, MoE, Mamba hybrid,
xLSTM, encoder-decoder and vision-frontend configurations as plain
functions on nested parameter dicts, stacked by period as in the
reference."""
