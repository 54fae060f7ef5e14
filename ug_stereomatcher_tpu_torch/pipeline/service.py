"""Synchronous service endpoint — the GetDisparitiesGPU analog.

Wraps StereoEngine in the exact request/response shape of
srv/GetDisparitiesGPU.srv (request: imL, imR; response: three
DisparityImages and/or three foveated stacks) as served by
UG_GPU_matcher.cpp:497 ``disparitySrv``.  The reference's service-path
quirks (it calls the legacy ``matchStack`` and mis-indexes the stack rows
with height where width is needed, UG_GPU_matcher.cpp:559-563) are NOT
reproduced — this endpoint returns the main-path results, as SURVEY.md §7
prescribes for intended-math parity.  Each plane of the response comes
to the host through ``device.to_numpy``, whatever device matched it.
"""

from __future__ import annotations

import time
from typing import Optional

from ug_stereomatcher_tpu_torch.device import to_numpy
from ug_stereomatcher_tpu_torch.engine import StereoEngine
from ug_stereomatcher_tpu_torch.pipeline.messages import (
    DisparityMessage,
    FoveatedStackMessage,
    GetDisparitiesRequest,
    GetDisparitiesResponse,
    Header,
)


class DisparityService:
    """In-process request/response matcher service."""

    def __init__(self, engine: Optional[StereoEngine] = None,
                 foveated: bool = False):
        self.engine = engine or StereoEngine()
        self.foveated = foveated
        self.requests_served = 0

    def __call__(self, request: GetDisparitiesRequest
                 ) -> GetDisparitiesResponse:
        header = Header(seq=self.requests_served + 1, stamp=time.time(),
                        frame_id="left_camera")
        if self.foveated:
            st = self.engine.match_foveated(request.left, request.right)

            def fmsg(plane):
                return FoveatedStackMessage(
                    image_stack=to_numpy(plane),
                    im_width=st.im_width, im_height=st.im_height,
                    roi_width=st.roi_width, roi_height=st.roi_height,
                    num_levels=st.num_levels, header=header)

            rsp = GetDisparitiesResponse(
                fdisp_h=fmsg(st.stack_h),
                fdisp_v=fmsg(st.stack_v),
                fdisp_c=fmsg(st.stack_c))
        else:
            res = self.engine.match(request.left, request.right)
            rsp = GetDisparitiesResponse(
                disp_h=DisparityMessage(to_numpy(res.disparity_h), header),
                disp_v=DisparityMessage(to_numpy(res.disparity_v), header),
                disp_c=DisparityMessage(to_numpy(res.confidence), header))
        self.requests_served += 1
        return rsp
