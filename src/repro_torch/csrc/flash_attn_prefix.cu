// The prefix-LM instantiations of flash attention (flash_attn.cu:
// PREFIX = true, PaliGemma's image prefix), built as a translation unit of
// their own so that they compile beside the others.
#define REPRO_FLASH_PREFIX_TU
#include "flash_attn.cu"
