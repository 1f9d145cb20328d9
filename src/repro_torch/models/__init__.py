"""The LM side path's models (port of ``repro.models``): configs, layers,
attention (GQA and MLA), MoE, the recurrent mixers (Mamba2, mLSTM, sLSTM)
and the transformer assembly with forward, loss and decode."""
