"""The plain reference that decides `correct`: MFCC, the DeepSpeech forward,
the CTC loss with its gradients and Adam, and the CTC prefix beam search,
written from their published descriptions in plain PyTorch and NumPy. It
imports nothing of the program and takes nothing that the program made."""
