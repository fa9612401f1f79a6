"""The LM family (dense GQA transformers) on PyTorch."""
