"""L7: command-line applications of the port.

``python -m mauvealigner_tpu_torch.tools mauveAligner ...`` keeps the
reference's tool name.  See cli.py.
"""
