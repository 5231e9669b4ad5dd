"""The models that consume the decode kernels: two-tower retrieval
(``recsys``) and GIN over compressed adjacency (``gnn``)."""
