from dssm_tpu_torch.serve.retrieval import (  # noqa: F401
    build_doc_index,
    embed_queries,
    load_index,
    save_index,
    top_k,
)
