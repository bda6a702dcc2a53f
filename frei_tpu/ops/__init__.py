from .planck import bb_flux, planck_lambda
from .twostream import (TwoStreamCouplers, e_correction, propagate_fluxes,
                        two_stream_couplers)
from .rebin import bin_codes, reference_bin_scaling, resort_rebin
