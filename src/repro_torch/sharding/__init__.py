"""Distribution of the LM substrate: the logical-axis sharding policy
over DTensor (``policy.py``) and the GPipe pipeline over
``torch.distributed`` (``pipeline.py``)."""
