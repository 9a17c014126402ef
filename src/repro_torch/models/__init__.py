"""The LM substrate of the port: model configuration (`config`), the
shared layer library (`layers`), the recurrent mixers (`recurrent`), the
backbone assembly (`transformer`) and its facade (`model`).

Counterpart of the reference's `repro/models/` without its sharding:
full-sequence forward (training and prefill), the training loss, the
enc-dec encoder and one-token decode through caches. Parameters and
caches are plain nested dicts of tensors in the reference's layout
(stacked segments keep a leading `repeats` axis), so
`repro_torch.convert.model_params_from_reference` carries the
reference's parameters across leaf by leaf.
"""
