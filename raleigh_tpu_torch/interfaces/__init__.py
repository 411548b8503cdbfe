# front ends: partial_hevp
