from rag_serving_system_torch.training.contrastive import (
    adamw,
    contrastive_loss,
    load_checkpoint,
    make_train_step,
    pair_batches,
    save_checkpoint,
    train_encoder,
)
