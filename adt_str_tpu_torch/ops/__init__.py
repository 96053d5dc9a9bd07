"""The port's kernels: their wrappers, plain versions and builds.

Importing this package registers, in the `adt_str_tpu_torch` namespace, the
custom ops of the kernels that greedy decoding launches (K1, K5f, LayerNorm,
the product and attention_rows; `_build.register_op`): a program saved by
`torch.export` from the port needs this import, and no other module of the
port, to load and run.
"""

from adt_str_tpu_torch.ops import attention_rows, cuda_attention, cuda_mel, layer_norm, linear  # noqa: F401


def op_wrappers() -> dict:
    """Each registered op's name -> the wrapper whose `launches` its launches
    on the card add to (`add_layer_norm` counts on `layer_norm`)."""
    return {"log_mel": cuda_mel.log_mel, "log_mel_any_hop": cuda_mel.log_mel_any_hop,
            "log_mel_long_hop": cuda_mel.log_mel_long_hop,
            **{wrapper.__name__: wrapper for wrapper, *_ in cuda_attention.FORWARD_ROUTES.values()},
            "layer_norm": layer_norm.layer_norm, "add_layer_norm": layer_norm.layer_norm, "linear": linear.linear,
            "attention_rows": attention_rows.attention, "attention_rows_split": attention_rows.attention_split}
