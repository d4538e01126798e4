"""Training through the port: ESD concept erasure, the denoising
fine-tune, SD3 flow matching, LoRA adapters, UCE/RECE editing, and
checkpoint/resume. Counterpart of ``safe_denoiser_tpu/training``, with
its ``__all__``."""

from .checkpoint import restore_train_state, save_train_state
from .esd import (ESDConfig, ddpm_loss, esd_loss, esd_param_mask,
                  make_esd_train_step, make_optimizer, make_train_step,
                  sample_xt_for_esd)
from .flow import (flow_matching_loss, make_flow_train_step,
                   sample_sigmas_logit_normal)
from .lora import (apply_lora, init_lora_params, load_lora, lora_scale,
                   lora_target_paths, make_lora_esd_train_step,
                   make_lora_train_step, merge_lora_into, save_lora)
from .uce import (cross_attn_kv_paths, edit_unet_concepts, rece_edit,
                  uce_edit, uce_edit_kernel)

__all__ = ["ESDConfig", "esd_loss", "ddpm_loss", "esd_param_mask",
           "make_esd_train_step", "make_train_step", "make_optimizer",
           "sample_xt_for_esd", "uce_edit", "uce_edit_kernel", "rece_edit",
           "edit_unet_concepts", "cross_attn_kv_paths",
           "flow_matching_loss", "make_flow_train_step",
           "sample_sigmas_logit_normal",
           "save_train_state", "restore_train_state",
           "init_lora_params", "apply_lora", "lora_scale",
           "lora_target_paths", "make_lora_esd_train_step",
           "make_lora_train_step", "merge_lora_into", "save_lora",
           "load_lora"]
