from repro_torch.models.transformer import (Transformer, decode_step,
                                            forward, init_cache, lm_loss,
                                            model_spec)
from repro_torch.models.layers import init_params
